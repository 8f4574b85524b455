"""The guided denoiser's grouped single-head cross-attention core: the CUDA
kernel's wrapper, its plain PyTorch version and the rule that picks one.

For one condition stream of one layer of
``ops/transformer.TransformerDecoderLayer2Att.guided``, everything between
``q_all = mod.q_proj(tgt2)`` and ``mod.out_proj(out)``: the query rows of
each guidance branch attend over the real variant's keys and values when
the stream is real in that branch (``REAL_BRANCHES``) and over the uncond
variant's otherwise; the full-condition branch's weights come back for the
attention maps.

``cross_attend_reference`` is the plain sequence: ``index_select`` of each
variant's branch rows, ``MultiheadAttention.grouped_attend`` per variant,
``index_copy_`` back.  ``cross_attend`` launches ``csrc/cross_attend.cu``
(one launch for both variants, rows read and written in place by the
branch lists) on CUDA tensors, or raises on what the kernel does not take
(``unsupported``).  ``grouped_cross_attend``, which ``guided`` calls, takes
the plain version where ``plain_reason`` finds one of its reasons (the
CPU, grad on, a tensor-parallel placement, active attention dropout, a
dtype other than bf16, a Tk whose row does not fit a block) and
``cross_attend`` otherwise, so that an on-card bf16 call the kernel cannot
take raises rather than running the plain version.  It counts
``cross_attend.launches`` (host launches of the kernel; a graph replay
launches none) and ``cross_attend.plain`` (on-card calls that took the
plain version).  The kernel is built by ``ops/nvcc.py`` at first use, or
from ``start_build`` on, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from convofusion_tpu_torch.ops import nvcc
from convofusion_tpu_torch.ops.attention import _sqrt_in
from convofusion_tpu_torch.utils import profiling

# the kernel's geometry (csrc kThreads, kRows, kKeyChunk, kStages, kCols,
# kPad, kMaxBranches, kD)
THREADS = 256
ROWS = 32             # query rows a block
KEY_CHUNK = 32        # keys a K chunk; Tk is padded to a multiple
STAGES = 3            # K chunks in shared memory
COLS = 128            # output columns a pass of P v
D_MODEL = 512         # the model width the kernel is built for (csrc kD)
PAD = 8               # bf16 elements of row padding in shared memory
MAX_BRANCHES = 8
# dynamic shared memory a block may take: the H100's 227 KB a block less
# the kernel's 1 KB of static row tables
MAX_SHARED_BYTES = 227 * 1024 - 1024
ALIGN = 16            # bytes: every row the kernel copies (cp.async)

SOURCE = nvcc.CSRC / "cross_attend.cu"
LIBRARY = nvcc.BUILD / "libcross_attend.so"

KV = Tuple[torch.Tensor, torch.Tensor]


# ------------------------------------------------------ the plain version

def cross_attend_reference(mod, q_all: torch.Tensor, kv_real: KV,
                           kv_unc: KV, mask_real: Optional[torch.Tensor],
                           mask_unc: Optional[torch.Tensor],
                           r_idx: torch.Tensor, u_idx: torch.Tensor):
    """The branch rows ``r_idx`` of ``q_all`` (G, B, Tq, D) over the real
    keys and values ``kv_real`` (B, Tk, D), the rows ``u_idx`` over the
    uncond ones (B or 1, Tk, D), through ``mod.grouped_attend``.  Returns
    (out (G, B, Tq, D), the last real branch's weights (B, Tq, Tk))."""
    (k_r, v_r), (k_u, v_u) = kv_real, kv_unc
    o_r, w_r = mod.grouped_attend(q_all.index_select(0, r_idx), k_r, v_r,
                                  mask_real)
    o_u, _ = mod.grouped_attend(q_all.index_select(0, u_idx), k_u, v_u,
                                mask_unc)
    out = torch.empty_like(q_all)
    out.index_copy_(0, r_idx, o_r)
    out.index_copy_(0, u_idx, o_u)
    return out, w_r[-1]   # last real branch = full condition


# ------------------------------------------------------------- the rule

def key_padding(tk: int) -> int:
    """Tk rounded up to whole K chunks, as the kernel pads it."""
    return -(-tk // KEY_CHUNK) * KEY_CHUNK


def shared_bytes(d: int, tks: Sequence[int]) -> int:
    """A block's dynamic shared memory (csrc ``cross_attend_kernel``): the
    bf16 logits of ROWS rows and their mask bytes, then the larger of q
    with STAGES K chunks and of two V passes with an output tile, at the
    largest padded Tk of ``tks``."""
    tkp = max(key_padding(tk) for tk in tks)
    stage = max((ROWS + STAGES * KEY_CHUNK) * (d + PAD),
                (2 * tkp + ROWS) * (COLS + PAD))
    return 2 * ROWS * (tkp + PAD) + ROWS * tkp + 2 * stage


def unc_branches(real: Sequence[int], g: int) -> Tuple[int, ...]:
    return tuple(i for i in range(g) if i not in real)


def _kv_reason(name, k, v, mask, b, d, dev):
    if k.dim() != 3 or k.shape != v.shape or k.shape[2] != d:
        return (f"{name} K/V of shapes {tuple(k.shape)}, {tuple(v.shape)}, "
                f"not (B or 1, Tk, {d})")
    if k.shape[0] not in (1, b) or k.shape[1] < 1:
        return f"{name} K/V batch {k.shape[0]} with queries of batch {b}"
    for t in (k, v):
        if t.dtype != torch.bfloat16 or t.device != dev:
            return f"{name} K/V {t.dtype} on {t.device}, not bf16 on {dev}"
        strides = (t.stride(1),) + ((t.stride(0),) if t.shape[0] > 1 else ())
        if t.stride(2) != 1 or t.data_ptr() % ALIGN or \
                any(s * 2 % ALIGN for s in strides):
            return (f"{name} K/V rows not contiguous and {ALIGN}-byte "
                    f"aligned (strides {t.stride()})")
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != dev or \
                mask.dim() != 2 or mask.shape[1] != k.shape[1] or \
                mask.shape[0] not in (1, b) or mask.stride(1) != 1:
            return (f"{name} mask {mask.dtype} {tuple(mask.shape)} on "
                    f"{mask.device}: not bool (1 or {b}, {k.shape[1]}) "
                    f"rows on {dev}")
    return None


def _fit_reason(d: int, tks: Sequence[int]) -> Optional[str]:
    need = shared_bytes(d, tks)
    if need > MAX_SHARED_BYTES:
        return (f"Tk {', '.join(map(str, tks))}: {need} bytes of shared "
                f"memory, over {MAX_SHARED_BYTES}")
    return None


def unsupported(q_all, kv_real: KV, kv_unc: KV, mask_real, mask_unc,
                real: Sequence[int]) -> Optional[str]:
    """Why the kernel does not take these tensors, or None: dtypes, shapes,
    strides and shared memory first, the device last."""
    if q_all.dtype != torch.bfloat16:
        return f"q_all is {q_all.dtype}, not bf16"
    if q_all.dim() != 4 or not q_all.is_contiguous():
        return f"q_all of shape {tuple(q_all.shape)}: not contiguous 4-D"
    g, b, _, d = q_all.shape
    if d != D_MODEL or q_all.data_ptr() % ALIGN:
        return f"D {d}: not {D_MODEL}, or q_all misaligned"
    if not 0 < len(real) <= g <= MAX_BRANCHES or \
            list(real) != sorted(set(real)) or real[-1] >= g:
        return f"real branches {tuple(real)} of {g}"
    for name, (k, v), mask in (("real", kv_real, mask_real),
                               ("uncond", kv_unc, mask_unc)):
        reason = _kv_reason(name, k, v, mask, b, d, q_all.device)
        if reason:
            return reason
    reason = _fit_reason(d, (kv_real[0].shape[1], kv_unc[0].shape[1]))
    if reason:
        return reason
    if q_all.device.type != "cuda":
        return f"on {q_all.device}, not on a card"
    return None


def plain_reason(mod, q_all, kv_real: KV, kv_unc: KV) -> Optional[str]:
    """Why this call takes the plain version, or None where it goes to the
    kernel: the CPU, grad enabled, ``mod`` placed by tensor parallelism,
    active attention dropout, ``q_all`` not bf16 (the fp32 CLIs), or a Tk
    whose logits row does not fit a block.  Nothing else: the kernel route
    raises on any other call it cannot take (:func:`cross_attend`)."""
    if q_all.device.type != "cuda":
        return f"on {q_all.device}, not on a card"
    if torch.is_grad_enabled():
        return "grad is enabled"
    if mod.tp is not None:
        return "a tensor-parallel placement"
    drop = mod.attn_dropout
    if drop.training and drop.p > 0.0:
        return "attention dropout is active"
    if q_all.dtype != torch.bfloat16:
        return f"q_all is {q_all.dtype}, not bf16"
    return _fit_reason(q_all.shape[-1],
                       (kv_real[0].shape[1], kv_unc[0].shape[1]))


def grouped_cross_attend(mod, q_all, kv_real: KV, kv_unc: KV, mask_real,
                         mask_unc, real: Sequence[int], r_idx, u_idx):
    """``guided``'s core for one stream: :func:`cross_attend` where
    :func:`plain_reason` finds nothing, else
    :func:`cross_attend_reference`.  ``mod``: the stream's single-head
    cross-attention; ``real``: its real branches (``REAL_BRANCHES``);
    ``r_idx`` / ``u_idx``: the same and the rest as device tensors."""
    if plain_reason(mod, q_all, kv_real, kv_unc) is None:
        return cross_attend(q_all, kv_real, kv_unc, mask_real, mask_unc,
                            real)
    if q_all.device.type == "cuda":
        profiling.count("cross_attend.plain")
    return cross_attend_reference(mod, q_all, kv_real, kv_unc, mask_real,
                                  mask_unc, r_idx, u_idx)


# -------------------------------------------------------------- the kernel

def start_build() -> None:
    """Begin compiling ``csrc/cross_attend.cu`` in the background
    (``nvcc.start``), for a caller that will sample on a card."""
    nvcc.start(SOURCE, LIBRARY)


def build() -> str:
    """Compile ``csrc/cross_attend.cu``, or wait for :func:`start_build`'s
    compile; the compiler's report, or '' when the library is up to
    date."""
    return nvcc.build(SOURCE, LIBRARY)


class _CVariant(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("k", "v", "mask")]
                + [(n, ctypes.c_longlong) for n in (
                    "k_bstride", "k_rstride", "v_bstride", "v_rstride",
                    "m_bstride")]
                + [(n, ctypes.c_int) for n in (
                    "kv_batch", "mask_batch", "tk", "n_branches",
                    "att_branch", "tiles", "blocks")]
                + [("branches", ctypes.c_int * MAX_BRANCHES)])


class _CParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "out", "att")]
                + [(n, ctypes.c_int) for n in ("b", "tq", "d")]
                + [("inv_scale", ctypes.c_float), ("var", _CVariant * 2)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.cross_attend_params_bytes.restype = ctypes.c_int
    lib.cross_attend_init.argtypes = [ctypes.c_int]
    lib.cross_attend_init.restype = ctypes.c_int
    lib.cross_attend.argtypes = [_CParams, ctypes.c_int, ctypes.c_void_p]
    lib.cross_attend.restype = ctypes.c_int
    if lib.cross_attend_params_bytes() != ctypes.sizeof(_CParams):
        raise RuntimeError("csrc Params and _CParams differ in size")
    return lib


@functools.lru_cache(maxsize=None)
def _ready(device_index: int) -> ctypes.CDLL:
    """The library, with the kernel allowed MAX_SHARED_BYTES on this card
    (once a device, before its first launch)."""
    lib = _library()
    with torch.cuda.device(device_index):
        err = lib.cross_attend_init(MAX_SHARED_BYTES)
    if err != 0:
        raise RuntimeError(f"cross_attend: cudaFuncSetAttribute failed: "
                           f"CUDA error {err}")
    return lib


@functools.lru_cache(maxsize=None)
def _inv_scale(d: int) -> float:
    """1 / bf16(sqrt D) in fp32: CUDA divides a tensor by a host scalar as
    a product with its fp32 reciprocal."""
    return float(np.float32(1.0) / np.float32(_sqrt_in(d, torch.bfloat16)))


def _variant(k, v, mask, branches, att_branch, b, tq) -> _CVariant:
    kv_batch = k.shape[0]
    rows = len(branches) * (b // kv_batch) * tq
    tiles = -(-rows // ROWS)
    c = _CVariant()
    c.k, c.v = k.data_ptr(), v.data_ptr()
    c.mask = None if mask is None else mask.data_ptr()
    c.k_bstride, c.k_rstride = k.stride(0), k.stride(1)
    c.v_bstride, c.v_rstride = v.stride(0), v.stride(1)
    c.m_bstride = 0 if mask is None else mask.stride(0)
    c.kv_batch, c.tk = kv_batch, k.shape[1]
    c.mask_batch = 0 if mask is None else mask.shape[0]
    c.n_branches, c.att_branch = len(branches), att_branch
    c.tiles, c.blocks = tiles, kv_batch * tiles if branches else 0
    c.branches[:len(branches)] = branches
    return c


def cross_attend(q_all, kv_real: KV, kv_unc: KV, mask_real, mask_unc,
                 real: Sequence[int]):
    """The kernel's :func:`cross_attend_reference`: out (G, B, Tq, D) and
    the last real branch's weights (B, Tq, Tk_real), bf16, from q_all (G,
    B, Tq, D), the variants' K/V (B or 1, Tk, D; row views such as the
    halves of ``project_kv``'s output are taken as they are) and masks (B
    or 1, Tk; True = pad); ``real``: the real branches, ascending.  Raises
    on what the kernel does not take (:func:`unsupported`); launches on
    the current stream and counts the launch."""
    reason = unsupported(q_all, kv_real, kv_unc, mask_real, mask_unc, real)
    if reason:
        raise ValueError(f"cross_attend: {reason}")
    g, b, tq, d = q_all.shape
    real = tuple(real)
    (k_r, v_r), (k_u, v_u) = kv_real, kv_unc
    out = torch.empty_like(q_all)
    att = q_all.new_empty((b, tq, k_r.shape[1]))
    p = _CParams()
    p.q, p.out, p.att = q_all.data_ptr(), out.data_ptr(), att.data_ptr()
    p.b, p.tq, p.d = b, tq, d
    p.inv_scale = _inv_scale(d)
    p.var[0] = _variant(k_r, v_r, mask_real, real, real[-1], b, tq)
    p.var[1] = _variant(k_u, v_u, mask_unc, unc_branches(real, g), -1, b,
                        tq)
    dev = q_all.device
    lib = _ready(dev.index if dev.index is not None
                 else torch.cuda.current_device())
    with torch.cuda.device(dev):
        err = lib.cross_attend(
            p, shared_bytes(d, (k_r.shape[1], k_u.shape[1])),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_attend kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("cross_attend.launches")
    cross_attend.shapes.add(geometry(q_all, kv_real, kv_unc, mask_real,
                                     mask_unc, real))
    return out, att


def geometry(q_all, kv_real: KV, kv_unc: KV, mask_real, mask_unc,
             real: Sequence[int]):
    """What sets a launch's work: (B, Tq, real Tk, uncond Tk, uncond K/V
    batch, real and uncond mask batch (0: no mask), real branches)."""
    def rows(m):
        return 0 if m is None else m.shape[0]
    return (q_all.shape[1], q_all.shape[2], kv_real[0].shape[1],
            kv_unc[0].shape[1], kv_unc[0].shape[0], rows(mask_real),
            rows(mask_unc), tuple(real))


# the geometries launched with: a coverage check, not a count (the
# launches count in profiling.COUNTS)
cross_attend.shapes = set()
