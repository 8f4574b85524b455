"""Fused guidance combine + scheduler step: the CUDA kernel's wrapper and
its plain PyTorch version.

``guided_step`` replaces ``convofusion_tpu/ops/pallas_step.py::
fused_guided_step`` (kernel ``_kernel``, :36-77).  On CPU tensors it runs
``guided_step_reference``; on CUDA tensors it launches
``csrc/guided_step.cu`` or raises.  Both take their per-step scalars from
``step_coefs``, computed once a step on the host in the op order of
``pallas_step.py:54-75``.  ``_launch_geometry`` cuts the latents into the
kernel's tiles and bulk copies.  The kernel is built with ``nvcc`` for
``sm_90a`` into ``_build/`` at first use and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from convofusion_tpu_torch.utils import profiling

NUM_BRANCHES = 7
PLANES = 6            # branches 0-5 are read; branch 6 has weight 0
VEC = 8               # elements a thread takes per iteration (csrc kVec)
ALIGN = 16            # bytes: cp.async.bulk addresses and sizes
# a launch may take 48 KB of shared memory without cudaFuncSetAttribute;
# the kernel's mbarrier takes 8 bytes of it
MAX_SHARED_BYTES = 48 * 1024 - 8
# elements a block, by the branch planes' element size, and threads a
# block: the fastest of the sweep in PERF.md at the main path's case (bf16
# planes, DDIM, time in the reverse loop); fp32 planes take the largest
# tile under MAX_SHARED_BYTES with noise
TILE = {2: 1536, 4: 1024}
THREADS = 256

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "guided_step.cu"
LIBRARY = _PKG / "_build" / "libguided_step.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no --use_fast_math and no contracted multiply-adds: the kernel
    # rounds as guided_step_reference does
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


class StepCoefs(NamedTuple):
    """One step's scalars, each an fp32 value (csrc ``StepCoefs``)."""
    gs: float
    sqrt_at: float
    sqrt_bt: float
    inv_sqrt_at: float
    inv_sqrt_bt: float
    clip: float
    is_ddpm: float
    coef_x0: float
    coef_xt: float
    noise_std: float
    sqrt_aprev: float
    sqrt_bprev: float


@functools.lru_cache(maxsize=4096)
def _step_coefs(alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip):
    a_t, a_prev, gs, is_ddpm, add_noise, clip = (
        torch.tensor(v, dtype=torch.float32) for v in
        (alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip))
    beta_t = 1.0 - a_t
    beta_prev = 1.0 - a_prev
    sqrt_at = a_t.sqrt()
    sqrt_bt = beta_t.sqrt()
    cur_a = a_t / a_prev
    cur_b = 1.0 - cur_a
    coef_x0 = a_prev.sqrt() * cur_b / beta_t
    coef_xt = cur_a.sqrt() * beta_prev / beta_t
    var = (beta_prev / beta_t * cur_b).clamp(min=1e-20)
    return StepCoefs(*(float(v) for v in (
        gs, sqrt_at, sqrt_bt, 1.0 / sqrt_at, 1.0 / sqrt_bt, clip, is_ddpm,
        coef_x0, coef_xt, add_noise * var.sqrt(), a_prev.sqrt(),
        beta_prev.clamp(min=0.0).sqrt())))


def step_coefs(alpha_t, alpha_prev, gs, is_ddpm, add_noise,
               clip) -> StepCoefs:
    """The step's scalars from alpha_prod_t, alpha_prod_prev (1.0 when
    prev_t < 0), guidance scale and the is_ddpm, add_noise (t > 0) and
    clip flags.  fp32 arithmetic on 0-dim CPU tensors; cached, since a
    sampler repeats its timesteps from call to call."""
    return _step_coefs(*(float(v) for v in (alpha_t, alpha_prev, gs,
                                             is_ddpm, add_noise, clip)))


def guided_step_reference(noise_pred7, latents, noise, alpha_t, alpha_prev,
                          gs, is_ddpm, add_noise, clip):
    """Plain PyTorch version, fp32 throughout, in the kernel's op order."""
    c = step_coefs(alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip)
    noise_pred7 = noise_pred7.float()
    lat = latents.float()
    uncond = noise_pred7[0]
    single = (noise_pred7[1] + noise_pred7[2] + noise_pred7[3]
              + noise_pred7[4] + noise_pred7[5])
    eps = uncond + c.gs * (single - 5.0 * uncond)
    x0 = (lat - c.sqrt_bt * eps) * c.inv_sqrt_at
    x0 = x0.clamp(-1, 1) if c.clip > 0 else x0
    if c.is_ddpm > 0:
        out = c.coef_x0 * x0 + c.coef_xt * lat + c.noise_std * noise.float()
    else:
        eps2 = (lat - c.sqrt_at * x0) * c.inv_sqrt_bt
        out = c.sqrt_aprev * x0 + c.sqrt_bprev * eps2
    return out.to(latents.dtype)


class Copy(NamedTuple):
    """One bulk copy of a block: ``nbytes`` from ``offset`` bytes into
    ``source`` ('np7', 'latents' or 'noise') to ``shared`` bytes into the
    block's shared buffer."""
    source: str
    offset: int
    shared: int
    nbytes: int


class Geometry(NamedTuple):
    tile: int            # elements a block; the last block may have fewer
    blocks: int
    threads: int
    shared_bytes: int    # dynamic shared memory a block
    copies: Tuple[Tuple[Copy, ...], ...]   # per block; noise last


@functools.lru_cache(maxsize=None)
def _launch_geometry(n: int, elem_size: int, tile: int,
                     threads: int) -> Geometry:
    """The kernel's launch for n latent elements and branch planes of
    ``elem_size`` bytes: block b copies elements [b*tile, min((b+1)*tile,
    n)) of planes 0-5, of the latents and (on DDPM steps with t > 0) of
    the noise.  The kernel computes the same offsets from tile and n."""
    if n % VEC or tile % VEC:
        raise ValueError(f"n {n} and tile {tile} must be multiples of {VEC}")
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads {threads}: whole warps, at most 256")
    f32 = 4
    plane_bytes = tile * elem_size
    shared = PLANES * plane_bytes + 2 * tile * f32
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"tile {tile} needs {shared} bytes of shared "
                         f"memory, over {MAX_SHARED_BYTES}")
    blocks = -(-n // tile)
    copies = []
    for b in range(blocks):
        start = b * tile
        m = min(tile, n - start)
        block = [Copy("np7", (k * n + start) * elem_size, k * plane_bytes,
                      m * elem_size) for k in range(PLANES)]
        block.append(Copy("latents", start * f32, PLANES * plane_bytes,
                          m * f32))
        block.append(Copy("noise", start * f32,
                          PLANES * plane_bytes + tile * f32, m * f32))
        copies.append(tuple(block))
    return Geometry(tile, blocks, threads, shared, tuple(copies))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernel")
    return nvcc


def build() -> str:
    """Compile ``csrc/guided_step.cu`` into ``_build/`` unless a library
    newer than every file under ``csrc/`` is there.  Returns the
    compiler's output (register and spill report), or '' when nothing was
    built."""
    newest = max(p.stat().st_mtime for p in CSRC.rglob("*") if p.is_file())
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return ""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIBRARY)
    return res.stdout + res.stderr


class _CStepCoefs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in StepCoefs._fields]


@functools.lru_cache(maxsize=4096)
def _c_coefs(coefs: StepCoefs) -> _CStepCoefs:
    return _CStepCoefs(*coefs)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    args = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, _CStepCoefs]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (lib.guided_step_f32, lib.guided_step_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(noise_pred7, latents, noise):
    dev = latents.device
    for name, x in (("noise_pred7", noise_pred7), ("noise", noise)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, latents on {dev}")
    if noise_pred7.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"noise_pred7 must be fp32 or bf16, "
                        f"not {noise_pred7.dtype}")
    if latents.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError("latents and noise must be fp32")
    if noise.shape != latents.shape or \
            noise_pred7.shape != (NUM_BRANCHES,) + latents.shape:
        raise ValueError(
            f"shapes: noise_pred7 {tuple(noise_pred7.shape)}, latents "
            f"{tuple(latents.shape)}, noise {tuple(noise.shape)}")
    if latents.numel() % VEC:
        raise ValueError(f"latents numel must be a multiple of {VEC}: each "
                         f"plane of noise_pred7 then starts 16-byte aligned "
                         f"for the bulk copies")
    for name, x in (("noise_pred7", noise_pred7), ("latents", latents),
                    ("noise", noise)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned")


def guided_step(noise_pred7, latents, noise, alpha_t, alpha_prev, gs,
                is_ddpm, add_noise, clip):
    """Next latents (B, T, D) fp32 from noise_pred7 (7, B, T, D) fp32 or
    bf16, latents and noise (B, T, D) fp32, and six scalars (Python
    floats): alpha_prod_t, alpha_prod_prev (1.0 when prev_t < 0), guidance
    scale, is_ddpm, add_noise (t > 0), clip."""
    if latents.device.type == "cpu":
        return guided_step_reference(noise_pred7, latents, noise, alpha_t,
                                     alpha_prev, gs, is_ddpm, add_noise,
                                     clip)
    if latents.device.type != "cuda":
        raise ValueError(f"guided_step runs on cpu or cuda, not "
                         f"{latents.device}")
    _check(noise_pred7, latents, noise)
    es = noise_pred7.element_size()
    geom = _launch_geometry(latents.numel(), es, TILE[es], THREADS)
    return _launch(noise_pred7, latents, noise,
                   step_coefs(alpha_t, alpha_prev, gs, is_ddpm, add_noise,
                              clip),
                   is_ddpm > 0 and add_noise != 0, geom)


def _launch(noise_pred7, latents, noise, coefs, read_noise, geom):
    """Launch on the current stream (checked tensors) and count it."""
    lib = _library()
    fn = (lib.guided_step_f32 if noise_pred7.dtype == torch.float32
          else lib.guided_step_bf16)
    out = torch.empty_like(latents)
    with torch.cuda.device(latents.device):
        err = fn(noise_pred7.data_ptr(), latents.data_ptr(),
                 noise.data_ptr(), out.data_ptr(), latents.numel(),
                 _c_coefs(coefs), int(read_noise), geom.tile, geom.blocks,
                 geom.threads, geom.shared_bytes,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"guided_step kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("guided_step.launches")
    guided_step.shapes.add((tuple(latents.shape), noise_pred7.dtype))
    return out


# the (latents shape, plane dtype) pairs launched with: a coverage check,
# not a count (the launches count in profiling.COUNTS)
guided_step.shapes = set()
