"""The guided denoiser's LayerNorms, written in the dtype of the Linear that
reads them: the CUDA kernel's wrapper, its plain PyTorch version and the
rule that picks one.

A ``LayerNorm`` computes and returns fp32 (``ops/layers.py``), and the bf16
``Linear`` after it rounds its input to bf16; JAX rounds at the same point
(``nn.Dense(dtype=bf16)``).  In ``TransformerDecoderLayer2Att.guided``,
``TimeBlock.guided`` and ``DenoiserDecoder.guided`` each LayerNorm feeds
such a Linear, so :func:`normalize` returns the norm already rounded to the
Linear's dtype: the same values, with the upcast, the fp32 output and the
casts left out.  For ``TimeBlock`` it also applies the modulation
``* (1 + scale) + shift`` and the SiLU that come between the norm and the
Linear.

``layer_norm_reference`` is the plain sequence: ``F.layer_norm`` over the
fp32 input, the epilogue in fp32, the cast.  ``layer_norm`` launches
``csrc/layer_norm.cu`` on CUDA tensors (rows of any width D that is a
multiple of 4, up to ``MAX_D``), or raises on what the kernel does not take
(``unsupported``).  ``normalize`` takes the plain version where
``plain_reason`` finds one of its reasons (the CPU, grad on, a
tensor-parallel placement, a compute dtype other than bf16) and
``layer_norm`` otherwise, so that an on-card bf16 call the kernel cannot
take raises rather than running the plain version; so does an active
dropout between the epilogue and the Linear on that route.  It counts
``layer_norm.launches`` (host launches of the kernel; a graph replay
launches none) and ``layer_norm.plain`` (on-card calls that took the plain
version).  The kernel is built by ``ops/nvcc.py`` at first use, or from
``start_build`` on, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from convofusion_tpu_torch.ops import nvcc
from convofusion_tpu_torch.utils import profiling

MAX_D = 1024          # the widest row the kernel takes (csrc kMaxD)

SOURCE = nvcc.CSRC / "layer_norm.cu"
LIBRARY = nvcc.BUILD / "liblayer_norm.so"


# ------------------------------------------------------ the plain version

def layer_norm_reference(x: torch.Tensor, norm, dtype: torch.dtype,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``norm(x)`` (fp32 math on the fp32 input), with ``scale`` and
    ``shift`` ``silu(y * (1 + scale) + shift)`` (``1 + scale`` in their own
    dtype, the rest in fp32), rounded to ``dtype``."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                     norm.bias, norm.eps)
    if scale is not None:
        y = F.silu(y * (1 + scale) + shift)
    return y.to(dtype)


# ------------------------------------------------------------- the rule

def _dtype(consumer) -> torch.dtype:
    """The compute dtype of a ``Linear`` or a ``MultiheadAttention``."""
    return getattr(consumer, "dtype", None) or consumer.weight.dtype


def plain_reason(x: torch.Tensor, consumer) -> Optional[str]:
    """Why this call takes the plain version, or None where it goes to the
    kernel: the CPU, grad enabled, ``consumer`` (the module that reads the
    norm) placed by tensor parallelism or computing in another dtype than
    bf16 (the fp32 CLIs).  Nothing else: the kernel route raises on any
    other call it cannot take (:func:`normalize`, :func:`layer_norm`)."""
    if x.device.type != "cuda":
        return f"on {x.device}, not on a card"
    if torch.is_grad_enabled():
        return "grad is enabled"
    if consumer.tp is not None:
        return "a tensor-parallel placement"
    if _dtype(consumer) != torch.bfloat16:
        return f"the consumer computes in {_dtype(consumer)}, not bf16"
    return None


def normalize(norm, x: torch.Tensor, consumer,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None, dropout=None
              ) -> torch.Tensor:
    """``norm(x)``, with ``scale`` and ``shift`` TimeBlock's epilogue, as
    ``consumer`` reads it: :func:`layer_norm` where :func:`plain_reason`
    finds nothing, else :func:`layer_norm_reference` rounded to the
    consumer's dtype (fp32 where ``dropout``, between the norm and the
    consumer, is active: it then comes before the consumer's own cast, as
    in the layer's ``forward``).  An active ``dropout`` on the kernel's
    route raises: the kernel rounds before it."""
    active = dropout is not None and dropout.training and dropout.p > 0.0
    reason = plain_reason(x, consumer)
    if reason is None:
        if active:
            raise ValueError("layer_norm: an active dropout between the "
                             "norm and its bf16 consumer, without grad on "
                             "a card")
        return layer_norm(x, norm, scale, shift)
    if x.device.type == "cuda":
        profiling.count("layer_norm.plain")
    return layer_norm_reference(x, norm,
                                torch.float32 if active else
                                _dtype(consumer), scale, shift)


# -------------------------------------------------------------- the kernel

def start_build() -> None:
    """Begin compiling ``csrc/layer_norm.cu`` in the background
    (``nvcc.start``), for a caller that will sample on a card."""
    nvcc.start(SOURCE, LIBRARY)


def build() -> str:
    """Compile ``csrc/layer_norm.cu``, or wait for :func:`start_build`'s
    compile; the compiler's report, or '' when the library is up to
    date."""
    return nvcc.build(SOURCE, LIBRARY)


class _CParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "y", "weight", "bias", "scale", "shift")]
        + [(n, ctypes.c_longlong) for n in ("rows", "x_inner", "x_outer",
                                             "mod_stride")]
        + [(n, ctypes.c_int) for n in ("rows_per_batch", "batches",
                                        "x_bf16", "d")]
        + [("eps", ctypes.c_float)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.layer_norm_params_bytes.restype = ctypes.c_int
    lib.layer_norm.argtypes = [_CParams, ctypes.c_void_p]
    lib.layer_norm.restype = ctypes.c_int
    if lib.layer_norm_params_bytes() != ctypes.sizeof(_CParams):
        raise RuntimeError("csrc Params and _CParams differ in size")
    return lib


def _modulation_reason(x, scale, shift) -> Optional[str]:
    """Why the epilogue's ``scale`` and ``shift`` do not fit the kernel:
    bf16 rows of D on x's device, one a batch row, broadcast over the
    leading (branch) and the token dimensions of ``x`` (G, B, T, D)."""
    if x.dim() != 4:
        return f"x of shape {tuple(x.shape)} with an epilogue: not 4-D"
    want = (1, x.shape[1], 1, x.shape[3])
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.bfloat16 or t.device != x.device or \
                tuple(t.shape) != want:
            return (f"{name} {t.dtype} {tuple(t.shape)} on {t.device}: not "
                    f"bf16 {want} on {x.device}")
        if t.stride(3) != 1 or t.stride(1) != scale.stride(1) or \
                t.stride(1) * 2 % 8 or t.data_ptr() % 8:
            return (f"{name} rows not contiguous, 8-byte aligned and "
                    f"strided as scale's (strides {t.stride()})")
    return None


def unsupported(x: torch.Tensor, norm, scale=None, shift=None
                ) -> Optional[str]:
    """Why the kernel does not take these tensors, or None: dtypes, shapes,
    strides and the norm first, the device last."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"x is {x.dtype}, not fp32 or bf16"
    d = x.shape[-1] if x.dim() else 0
    if d % 4 or not 0 < d <= MAX_D or x.numel() == 0:
        return (f"x of shape {tuple(x.shape)}: not (..., D), D a multiple "
                f"of 4 up to {MAX_D}")
    # the kernel reads vectors of 4 elements
    align = 4 * x.element_size()
    if x.dim() < 2 or not x[0].is_contiguous() or \
            x.stride(0) * x.element_size() % align or x.data_ptr() % align:
        return (f"x not (N, ...) of contiguous {align}-byte aligned blocks "
                f"(strides {x.stride()})")
    if tuple(norm.normalized_shape) != (d,) or \
            norm.weight is None or norm.bias is None:
        return f"a norm over {tuple(norm.normalized_shape)}, or without " \
               f"weight and bias"
    for name, t in (("weight", norm.weight), ("bias", norm.bias)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != x.device or t.data_ptr() % 16:
            return f"the norm's {name} {t.dtype} on {t.device}: not " \
                   f"contiguous aligned fp32 on {x.device}"
    if (scale is None) != (shift is None):
        return "scale without shift, or shift without scale"
    if scale is not None:
        reason = _modulation_reason(x, scale, shift)
        if reason:
            return reason
    if x.device.type != "cuda":
        return f"on {x.device}, not on a card"
    return None


def layer_norm(x: torch.Tensor, norm, scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's :func:`layer_norm_reference` in bf16: ``x`` (N, ...,
    D) fp32 or bf16, D a multiple of 4 up to ``MAX_D``, contiguous but for
    the stride of N; ``scale`` and
    ``shift`` (1, B, 1, D) bf16 rows for ``x`` (G, B, T, D), or None.
    Raises on what the kernel does not take (:func:`unsupported`);
    launches on the current stream and counts the launch."""
    reason = unsupported(x, norm, scale, shift)
    if reason:
        raise ValueError(f"layer_norm: {reason}")
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    p = _CParams()
    p.x, p.y = x.data_ptr(), y.data_ptr()
    p.weight, p.bias = norm.weight.data_ptr(), norm.bias.data_ptr()
    p.d = x.shape[-1]
    p.rows = x.numel() // p.d
    # the leading dimension may be strided, or a broadcast (stride 0: the
    # first layer's branches are one expanded tensor)
    p.x_inner, p.x_outer = p.rows // x.shape[0], x.stride(0)
    p.x_bf16 = int(x.dtype == torch.bfloat16)
    p.eps = _eps(norm.eps)
    if scale is not None:
        p.scale, p.shift = scale.data_ptr(), shift.data_ptr()
        p.mod_stride = scale.stride(1)
        p.rows_per_batch, p.batches = x.shape[2], x.shape[1]
    dev = x.device
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.layer_norm(p, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("layer_norm.launches")
    layer_norm.shapes.add(geometry(x, scale))
    return y


@functools.lru_cache(maxsize=None)
def _eps(eps: float) -> float:
    """eps in fp32, as PyTorch hands it to its kernel."""
    return float(np.float32(eps))


def geometry(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """What sets a launch's work: (rows, width, input dtype, the epilogue's
    (rows a batch row, batch rows), or None)."""
    mod = None if scale is None else (x.shape[2], x.shape[1])
    return (x.numel() // x.shape[-1], x.shape[-1],
            str(x.dtype).split(".")[-1], mod)


# the geometries launched with: a coverage check, not a count (the
# launches count in profiling.COUNTS)
layer_norm.shapes = set()
