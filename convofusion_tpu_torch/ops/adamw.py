"""AdamW over a whole trainable set: the CUDA kernel's wrapper and its plain
PyTorch version.

``adamw_step`` is ``optax.chain(clip_by_global_norm(c), adamw(...))`` on
fp32 masters and moments, from each parameter's gradient in its own dtype
(None where it got none), followed by the rounded copy of each master into
its low-precision weight.  On CPU tensors it runs ``adamw_reference``, the
``torch._foreach`` chain; on CUDA tensors it launches ``csrc/adamw.cu`` or
raises.  The kernel replaces no TPU kernel (optax is XLA's); it is one pass
in place of the chain's ~1,000 small kernels.  It takes its work from a
device table (``Table``: a descriptor a tensor, a row a chunk of
``CHUNK`` elements), made outside any CUDA graph capture so that a
captured step is one launch; ``TableCache`` keeps the tables of the
pointers an eager caller steps.  The kernel is built by ``ops/nvcc.py`` at
first use, or from ``start_build`` on, and loaded with ctypes.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from convofusion_tpu_torch.ops import nvcc
from convofusion_tpu_torch.utils import profiling

# optax.adamw's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8
# elements a block: the fastest of a sweep from 2,048 to 32,768 over stage
# 2's trainable set (PERF.md), by 3% over 8,192 (a shorter last wave)
CHUNK = 2048
VEC = 8               # elements a thread moves at a time (csrc kVec)
ALIGN = 16            # bytes: the vector loads' alignment
NORM_BLOCKS = 264     # the clip pre-pass's blocks (csrc kNormBlocks)
# a descriptor's int64 fields (csrc Desc) and flags
DESC_FIELDS = ("grad", "master", "mu", "nu", "weight", "numel", "flags",
               "unused")
FLAG_HAS_GRAD, FLAG_GRAD_BF16, FLAG_HAS_WEIGHT, FLAG_ALIGNED = 1, 2, 4, 8

SOURCE = nvcc.CSRC / "adamw.cu"
LIBRARY = nvcc.BUILD / "libadamw.so"


# ------------------------------------------------------ the plain version

def clip_by_global_norm(grads: Sequence[torch.Tensor], grad_clip: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients unchanged when their
    global norm (``norm``, else that of ``grads``) is below ``grad_clip``,
    else g / norm * c, decided on the device (``clip_grad_norm_`` would
    divide by norm + 1e-6); ``grad_clip`` 0 is off."""
    grads = list(grads)
    if not grad_clip:
        return grads
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    keep = norm < grad_clip
    one = torch.ones_like(norm)
    return torch._foreach_mul(
        torch._foreach_div(grads, torch.where(keep, one, norm)),
        torch.where(keep, one, one * grad_clip))


def adamw_updates(grads: Sequence[torch.Tensor], mu: List[torch.Tensor],
                  nu: List[torch.Tensor], params: Sequence[torch.Tensor],
                  scalars, weight_decay: float) -> List[torch.Tensor]:
    """``optax.adamw``'s updates of ``params`` from the (clipped) fp32
    ``grads``, advancing the moments in place.  ``scalars``: (-learning
    rate, 1 - b1**t, 1 - b2**t), host numbers or 0-dim fp32 tensors on the
    device, which give the same bits."""
    neg_lr, bc1, bc2 = scalars
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    if weight_decay:
        torch._foreach_add_(updates, list(params), alpha=weight_decay)
    torch._foreach_mul_(updates, neg_lr)
    return updates


def adamw_reference(grads: Sequence[Optional[torch.Tensor]],
                    masters: List[torch.Tensor], mu: List[torch.Tensor],
                    nu: List[torch.Tensor],
                    weights: Sequence[Optional[torch.Tensor]], scalars,
                    weight_decay: float, grad_clip: float,
                    norm: Optional[torch.Tensor] = None) -> None:
    """:func:`adamw_step` as the ``torch._foreach`` chain: each gradient in
    fp32 (zero where None), the clip, the moments and updates, the masters'
    add, the rounded masters into the weights that are not None."""
    grads = [torch.zeros_like(m) if g is None else g.float()
             for g, m in zip(grads, masters)]
    grads = clip_by_global_norm(grads, grad_clip, norm)
    torch._foreach_add_(masters, adamw_updates(grads, mu, nu, masters,
                                               scalars, weight_decay))
    lowp = [(w, m) for w, m in zip(weights, masters) if w is not None]
    if lowp:
        torch._foreach_copy_([w for w, _ in lowp], [m for _, m in lowp])


# ------------------------------------------------------------ the work list

def _pointer(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def work_list(grads, masters, mu, nu, weights, chunk: int = CHUNK):
    """The kernel's table as two numpy arrays: a descriptor (``DESC_FIELDS``)
    a tensor and a (tensor, index) int32 row a chunk of ``chunk``
    elements, every tensor's chunks in order."""
    if chunk <= 0 or chunk % VEC:
        raise ValueError(f"chunk {chunk}: a positive multiple of {VEC}")
    n = len(masters)
    desc = np.zeros((n, len(DESC_FIELDS)), np.int64)
    for i, (g, m, a, v, w) in enumerate(zip(grads, masters, mu, nu,
                                            weights)):
        ptrs = [_pointer(t) for t in (g, m, a, v, w)]
        flags = ((FLAG_HAS_GRAD if g is not None else 0)
                 | (FLAG_GRAD_BF16 if g is not None
                    and g.dtype == torch.bfloat16 else 0)
                 | (FLAG_HAS_WEIGHT if w is not None else 0)
                 | (FLAG_ALIGNED if all(p % ALIGN == 0 for p in ptrs)
                    else 0))
        desc[i] = ptrs + [m.numel(), flags, 0]
    counts = -(-desc[:, 5] // chunk)
    first = np.cumsum(counts) - counts
    tensor = np.repeat(np.arange(n), counts)
    chunks = np.stack([tensor, np.arange(counts.sum()) - first[tensor]],
                      axis=1).astype(np.int32)
    return desc, chunks


def prepass_norm(partials: torch.Tensor) -> torch.Tensor:
    """The clip's global norm as the kernel makes it from the pre-pass's
    ``partials`` (csrc ``adamw_kernel``: 256 threads each sum the partials
    of their stride, warp butterflies, the 8 warps in order, the square
    root), in fp32 numpy: a 0-dim fp32 tensor on their device, which the
    plain version takes as ``norm`` to give the kernel's bits."""
    p = partials.detach().cpu().numpy().astype(np.float32)
    lanes = np.zeros(256, np.float32)
    for t in range(256):
        for b in range(t, NORM_BLOCKS, 256):
            lanes[t] = lanes[t] + p[b]
    lanes = lanes.reshape(8, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    total = np.float32(0.0)
    for w in lanes[:, 0]:
        total = np.float32(total + w)
    return torch.tensor(np.sqrt(total), device=partials.device)


class Table(NamedTuple):
    """A work list on the device: ``buf`` holds the descriptors, then the
    chunks of ``chunk`` elements; ``partials`` the clip pre-pass's sums."""
    key: tuple
    buf: torch.Tensor
    partials: torch.Tensor
    n_tensors: int
    n_chunks: int
    chunk: int


def _key(grads, masters, mu, nu, weights) -> tuple:
    return tuple((_pointer(g), None if g is None else g.dtype,
                  m.data_ptr(), a.data_ptr(), v.data_ptr(), _pointer(w),
                  m.numel())
                 for g, m, a, v, w in zip(grads, masters, mu, nu, weights))


def make_table(grads, masters, mu, nu, weights, chunk: int = CHUNK
               ) -> Table:
    """The work list of these tensors on their card, copied on the current
    stream; not inside a capture.  The copy is from pageable memory, which
    CUDA stages at once (no host wait, no event): a pinned buffer's event,
    recorded on a stream that a graph later captures on, would be queried
    by the next pinned allocation of any thread during that capture, which
    invalidates it."""
    desc, chunks = work_list(grads, masters, mu, nu, weights, chunk)
    host = torch.from_numpy(np.concatenate([desc.ravel(),
                                            chunks.view(np.int64).ravel()]))
    dev = masters[0].device
    return Table(_key(grads, masters, mu, nu, weights),
                 host.to(dev, non_blocking=True),
                 torch.zeros(NORM_BLOCKS, dtype=torch.float32, device=dev),
                 len(desc), len(chunks), chunk)


class TableCache:
    """The tables of the last ``size`` sets of pointers an eager caller
    stepped, least recently used out first.  A table serves only the
    stream it was made on, so that its memory goes back to the allocator
    on the stream that used it."""

    def __init__(self, size: int = 4):
        self.size = size
        self._tables: "collections.OrderedDict[tuple, Table]" = \
            collections.OrderedDict()

    def clear(self) -> None:
        self._tables.clear()

    def get(self, grads, masters, mu, nu, weights) -> Optional[Table]:
        """The table of these CUDA tensors; None for CPU tensors."""
        if masters[0].device.type != "cuda":
            return None
        key = (torch.cuda.current_stream(masters[0].device).cuda_stream,
               _key(grads, masters, mu, nu, weights))
        table = self._tables.pop(key, None)
        if table is None:
            table = make_table(grads, masters, mu, nu, weights)
        self._tables[key] = table
        while len(self._tables) > self.size:
            self._tables.popitem(last=False)
        return table


# -------------------------------------------------------------- the kernel

def start_build() -> None:
    """Begin compiling ``csrc/adamw.cu`` in the background
    (``nvcc.start``), for a caller that will step on a card."""
    nvcc.start(SOURCE, LIBRARY)


def build() -> str:
    """Compile ``csrc/adamw.cu``, or wait for :func:`start_build`'s compile
    (``nvcc.build``); the compiler's report, or '' when the library is up
    to date."""
    return nvcc.build(SOURCE, LIBRARY)


class _CHyper(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "b1", "one_minus_b1", "b2", "one_minus_b2", "eps", "weight_decay",
        "grad_clip")]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.adamw_step.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                               + [_CHyper] + [ctypes.c_void_p] * 6)
    lib.adamw_step.restype = ctypes.c_int
    return lib


def _check(grads, masters, mu, nu, weights, scalars, norm):
    dev = masters[0].device
    if not len(grads) == len(masters) == len(mu) == len(nu) == len(weights):
        raise ValueError("grads, masters, mu, nu and weights differ in "
                         "length")
    for s in list(scalars) + ([] if norm is None else [norm]):
        if not torch.is_tensor(s) or s.dtype != torch.float32 or \
                s.device != dev or s.numel() != 1:
            raise TypeError("the scalars and norm must be one-element fp32 "
                            f"tensors on {dev}")
    for i, (g, m, a, v, w) in enumerate(zip(grads, masters, mu, nu,
                                            weights)):
        for name, t, dtypes in (("grad", g, (torch.bfloat16, torch.float32)),
                                ("master", m, (torch.float32,)),
                                ("mu", a, (torch.float32,)),
                                ("nu", v, (torch.float32,)),
                                ("weight", w, (torch.bfloat16,))):
            if t is None:
                if name in ("grad", "weight"):
                    continue
                raise ValueError(f"tensor {i}: {name} is None")
            if t.dtype not in dtypes:
                raise TypeError(f"tensor {i}: {name} is {t.dtype}, not one "
                                f"of {dtypes}")
            if t.device != dev:
                raise ValueError(f"tensor {i}: {name} on {t.device}, the "
                                 f"masters on {dev}")
            if t.shape != m.shape:
                raise ValueError(f"tensor {i}: {name} has shape "
                                 f"{tuple(t.shape)}, the master "
                                 f"{tuple(m.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"tensor {i}: {name} must be contiguous")


def adamw_step(grads: Sequence[Optional[torch.Tensor]],
               masters: List[torch.Tensor], mu: List[torch.Tensor],
               nu: List[torch.Tensor],
               weights: Sequence[Optional[torch.Tensor]], scalars,
               weight_decay: float, grad_clip: float,
               norm: Optional[torch.Tensor] = None,
               table: Optional[Table] = None) -> None:
    """One AdamW step in place: ``masters``, ``mu`` and ``nu`` (fp32) from
    ``grads`` (bf16 or fp32, None where a parameter got none), then each
    master rounded into its bf16 weight (None where the master is the
    parameter).  ``scalars``: (-learning rate, 1 - b1**t, 1 - b2**t);
    ``norm``: the gradients' global norm where they are shards of it.  On
    CUDA ``table`` is the work list (``make_table`` of these tensors,
    which a capture must be given); made here when None."""
    if not masters:
        return
    dev = masters[0].device
    if dev.type == "cpu":
        return adamw_reference(grads, masters, mu, nu, weights, scalars,
                               weight_decay, grad_clip, norm)
    if dev.type != "cuda":
        raise ValueError(f"adamw_step runs on cpu or cuda, not {dev}")
    _check(grads, masters, mu, nu, weights, scalars, norm)
    if table is None:
        table = make_table(grads, masters, mu, nu, weights)
    elif table.key != _key(grads, masters, mu, nu, weights):
        raise ValueError("the table was made for other tensors")
    _launch(table, scalars, weight_decay, grad_clip, norm)


def _launch(table: Table, scalars, weight_decay, grad_clip, norm):
    """Launch on the current stream (checked tensors) and count it."""
    hyper = _CHyper(B1, 1.0 - B1, B2, 1.0 - B2, EPS, weight_decay, grad_clip)
    neg_lr, bc1, bc2 = scalars
    dev = table.buf.device
    with torch.cuda.device(dev):
        err = _library().adamw_step(
            table.buf.data_ptr(), table.n_tensors, table.n_chunks,
            table.chunk,
            hyper, neg_lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            _pointer(norm), table.partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {err}")
    profiling.count("adamw.launches", 2 if grad_clip and norm is None else 1)
