"""Fused guidance combine + scheduler step: the CUDA kernel's wrapper and
its plain PyTorch version.

``guided_step`` replaces ``convofusion_tpu/ops/pallas_step.py::
fused_guided_step`` (kernel ``_kernel``, :36-77).  On CPU tensors it runs
``guided_step_reference``, a line-for-line mirror of
``reference_guided_step`` (:144-165); on CUDA tensors it launches
``csrc/guided_step.cu`` or raises.  The kernel is built with ``nvcc`` for
``sm_90a`` into ``_build/`` at first use and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

NUM_BRANCHES = 7

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "guided_step.cu"
LIBRARY = _PKG / "_build" / "libguided_step.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # IEEE division and sqrt (no --use_fast_math) and no contracted
    # multiply-adds: the kernel rounds as guided_step_reference does
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


def guided_step_reference(noise_pred7, latents, noise, alpha_t, alpha_prev,
                          gs, is_ddpm, add_noise, clip):
    """Plain PyTorch version, fp32 throughout.  Scalars are 0-dim fp32
    tensors on the CPU, so their arithmetic is fp32 as in the kernel and
    reads nothing back from the card."""
    alpha_prod_t, alpha_prod_prev, guidance_scale, is_ddpm, add_noise, \
        clip_sample = (torch.tensor(float(v), dtype=torch.float32) for v in
                       (alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip))
    noise_pred7 = noise_pred7.float()
    lat = latents.float()
    noise = noise.float()
    uncond = noise_pred7[0]
    single = (noise_pred7[1] + noise_pred7[2] + noise_pred7[3]
              + noise_pred7[4] + noise_pred7[5])
    eps = uncond + guidance_scale * (single - 5.0 * uncond)
    beta_t = 1.0 - alpha_prod_t
    beta_prev = 1.0 - alpha_prod_prev
    x0 = (lat - beta_t.sqrt() * eps) / alpha_prod_t.sqrt()
    x0 = x0.clamp(-1, 1) if clip_sample > 0 else x0
    eps2 = (lat - alpha_prod_t.sqrt() * x0) / beta_t.sqrt()
    cur_a = alpha_prod_t / alpha_prod_prev
    cur_b = 1 - cur_a
    coef_x0 = alpha_prod_prev.sqrt() * cur_b / beta_t
    coef_xt = cur_a.sqrt() * beta_prev / beta_t
    var = (beta_prev / beta_t * cur_b).clamp(min=1e-20)
    ddpm = coef_x0 * x0 + coef_xt * lat + add_noise * var.sqrt() * noise
    ddim = alpha_prod_prev.sqrt() * x0 + \
        beta_prev.clamp(min=0.0).sqrt() * eps2
    return (ddpm if is_ddpm > 0 else ddim).to(latents.dtype)


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
    """Compile ``csrc/guided_step.cu`` into ``_build/`` unless an up-to-date
    library is there.  Returns the compiler's output (register and spill
    report), or '' when nothing was built."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    args = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_float] * 6 + [ctypes.c_void_p])
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
    if latents.numel() % 4:
        raise ValueError("the kernel takes 4 elements a thread: latents "
                         "numel must be a multiple of 4")
    for name, x in (("noise_pred7", noise_pred7), ("latents", latents),
                    ("noise", noise)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    lib = _library()
    fn = (lib.guided_step_f32 if noise_pred7.dtype == torch.float32
          else lib.guided_step_bf16)
    out = torch.empty_like(latents)
    with torch.cuda.device(latents.device):
        err = fn(noise_pred7.data_ptr(), latents.data_ptr(),
                 noise.data_ptr(), out.data_ptr(), latents.numel(),
                 alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"guided_step kernel launch failed: CUDA error "
                           f"{err}")
    guided_step.launches += 1
    return out


guided_step.launches = 0
