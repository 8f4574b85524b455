#!/usr/bin/env python3
"""Time the fused step kernel of this tree against an earlier build of it,
on one NVIDIA GPU, in one process.

    python3 scripts/guided_step_compare.py --baseline-source OLD.cu

OLD.cu is an earlier ``convofusion_tpu_torch/csrc/guided_step.cu`` with
the twelve-argument C interface (np7, latents, noise, out, n, alpha_t,
alpha_prev, gs, is_ddpm, add_noise, clip, stream; one thread-per-4-elements
kernel, scalars computed on the card).  It is compiled with the same nvcc
flags into ``_build/baseline/``.  Versions run in turns (baseline, new,
new, baseline) so that both see the same card and the same clocks.

Prints, with the card's name and power limit:
  * the six cases of chip_smoke phase 3 at B = 96 (DDPM mid, DDPM final,
    DDIM; fp32 and bf16 branch planes): max |diff| against the plain
    version, kernel time with L2 flushed and back to back, for both;
  * in-path time: the kernel's device time a launch inside the bf16
    batch-96 DDIM reverse loop of the production model (profiler rows),
    for the baseline, the new kernel and every (tile, threads) of the
    sweep;
  * what sets the new kernel's time at B = 96: its time at other batch
    sizes (fixed cost against bytes), cold, back to back and as device
    time a launch (profiler rows, L2 warm), and the same for a
    one-element PyTorch kernel (a launch and nothing else) and for a
    PyTorch copy that moves the same bytes.
With ``--json PATH`` the whole summary is also written to PATH.
"""
import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from convofusion_tpu_torch.config import PRODUCTION  # noqa: E402
from convofusion_tpu_torch.data.synthetic import (  # noqa: E402
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models import convofusion as model_mod  # noqa: E402
from convofusion_tpu_torch.ops import guided_step as gs_mod  # noqa: E402
from convofusion_tpu_torch.ops import nvcc  # noqa: E402

IN_PATH_STEPS = 10
PROFILED_LAUNCHES = 50
SIZE_BATCHES = (1, 8, 96, 384, 1536)
log = cs.log


def build_baseline(source: Path) -> ctypes.CDLL:
    lib_path = gs_mod.LIBRARY.parent / "baseline" / "libguided_step.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc.find_nvcc(), *nvcc.FLAGS, "-o", str(lib_path), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    log(f"# build: baseline {source} in {time.perf_counter() - t0:.2f} s")
    lib = ctypes.CDLL(str(lib_path))
    args = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    for fn in (lib.guided_step_f32, lib.guided_step_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def baseline_step(lib):
    """guided_step's signature, launching the baseline kernel."""
    def step(noise_pred7, latents, noise, alpha_t, alpha_prev, gs, is_ddpm,
             add_noise, clip):
        gs_mod._check(noise_pred7, latents, noise)
        fn = (lib.guided_step_f32 if noise_pred7.dtype == torch.float32
              else lib.guided_step_bf16)
        out = torch.empty_like(latents)
        err = fn(noise_pred7.data_ptr(), latents.data_ptr(),
                 noise.data_ptr(), out.data_ptr(), latents.numel(),
                 alpha_t, alpha_prev, gs, is_ddpm, add_noise, clip,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
        return out
    return step


def check(step, args):
    got = step(*args)
    torch.cuda.synchronize()
    err = float((got - gs_mod.guided_step_reference(*args)).abs().max())
    if not err <= cs.KERNEL_TOL:
        raise RuntimeError(f"max |diff| {err} > {cs.KERNEL_TOL}")
    return err


def times(step, args, flush):
    return (cs._event_median_ms(lambda: step(*args), flush) * 1e3,
            cs._back_to_back_ms(lambda: step(*args)) * 1e3)


def device_us(fn):
    """Mean device time of a kernel of fn (which launches one), from the
    profiler's kernel rows over PROFILED_LAUNCHES calls: the kernel's own
    duration, without the launch gaps that back-to-back timing includes.
    The mean is over the kernels the profiler recorded, which may be
    fewer than the calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    count = sum(e.count for e in rows)
    if not 0 < count <= PROFILED_LAUNCHES:
        raise RuntimeError(f"profile shows {count} kernels for "
                           f"{PROFILED_LAUNCHES} calls")
    return sum(cs._device_us(e) for e in rows) / count


def phase_cases(base, flush):
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        np7, lat, noise, cases = cs.step_inputs(dtype)
        for name, scalars in cases.items():
            args = (np7, lat, noise) + scalars
            key = f"{name}/{str(dtype).split('.')[-1]}"
            errs = {v: check(s, args) for v, s in
                    (("baseline", base), ("new", gs_mod.guided_step))}
            runs = {"baseline": [], "new": []}
            for v in ("baseline", "new", "new", "baseline"):
                runs[v].append(times(base if v == "baseline"
                                     else gs_mod.guided_step, args, flush))
            row = {}
            for v, r in runs.items():
                row[v] = dict(max_abs_err=errs[v],
                              cold_us=[c for c, _ in r],
                              back_to_back_us=[w for _, w in r])
            bound, _ = cs.step_bound_ms(np7, lat,
                                        scalars[3] > 0 and scalars[4] > 0)
            row["bound_us"] = bound * 1e3
            out[key] = row
            log(f"# case {key}: bound {bound * 1e3:.2f} us; " + "; ".join(
                f"{v} max|diff| {row[v]['max_abs_err']:.3g} cold "
                f"{'/'.join(f'{t:.2f}' for t in row[v]['cold_us'])} us, "
                f"back to back "
                f"{'/'.join(f'{t:.2f}' for t in row[v]['back_to_back_us'])}"
                f" us" for v in ("baseline", "new")))
    return out


def in_path_us(model, cond, step=None, geometry=None):
    """Device time a launch of the step kernel in IN_PATH_STEPS reverse
    steps, with ``step`` in place of guided_step or the new kernel at
    ``geometry`` (tile, threads)."""
    saved = model_mod.guided_step
    ctx = (cs.step_geometry(*geometry) if geometry
           else contextlib.nullcontext())
    try:
        if step is not None:
            model_mod.guided_step = step
        with ctx, torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            model.diffusion_reverse(*cond, cs.BATCH,
                                    num_inference_steps=IN_PATH_STEPS,
                                    generator=torch.Generator(
                                        device="cuda").manual_seed(0))
            torch.cuda.synchronize()
    finally:
        model_mod.guided_step = saved
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return cs.kernel_in_path_us(kernels, IN_PATH_STEPS)


def phase_in_path(base):
    model = model_mod.Convofusion(PRODUCTION, dtype="bfloat16", seed=1)
    raw = synthetic_raw_batch(21, cs.BATCH,
                              mel_frames=PRODUCTION["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    with torch.inference_mode():
        cond_real, masks_real = model.encode_conditions(
            *(batch[k] for k in keys))
        cond_unc, masks_unc = model.encode_uncond(batch)
    cond = (cond_real, masks_real, cond_unc, masks_unc)
    in_path_us(model, cond)                           # warm-up
    out = {"baseline": [], "new": []}
    out["baseline"].append(in_path_us(model, cond, step=base))
    out["new"].append(in_path_us(model, cond))
    sweep = {}
    for tile, threads in cs.SWEEP:
        sweep[f"{tile}x{threads}"] = in_path_us(
            model, cond, geometry=(tile, threads))
    out["new"].append(in_path_us(model, cond))
    out["baseline"].append(in_path_us(model, cond, step=base))
    out["sweep"] = sweep
    log(f"# in path (bf16 B={cs.BATCH} DDIM, {IN_PATH_STEPS} steps): "
        f"baseline {'/'.join(f'{t:.2f}' for t in out['baseline'])} us, "
        f"new {'/'.join(f'{t:.2f}' for t in out['new'])} us")
    for k, v in sweep.items():
        log(f"# in path sweep tile x threads {k}: {v:.2f} us")
    return out


def phase_floor(flush):
    """What sets the new kernel's time at the main path's size."""
    out = {"batches": {}}
    for b in SIZE_BATCHES:
        np7, lat, noise, cases = cs.step_inputs(torch.bfloat16, batch=b)
        args = (np7, lat, noise) + cases["ddim"]
        check(gs_mod.guided_step, args)
        cold, warm = times(gs_mod.guided_step, args, flush)
        dev = device_us(lambda: gs_mod.guided_step(*args))
        bound, _ = cs.step_bound_ms(np7, lat, False)
        out["batches"][b] = dict(cold_us=cold, back_to_back_us=warm,
                                 device_us=dev, bound_us=bound * 1e3)
        log(f"# size bf16 DDIM B={b}: cold {cold:.2f} us, back to back "
            f"{warm:.2f} us, device {dev:.2f} us, bound "
            f"{bound * 1e3:.2f} us")
    one = torch.zeros(1, device="cuda")
    out["launch_only"] = times(lambda: one.add_(1.0), (), flush) + (
        device_us(lambda: one.add_(1.0)),)
    # a copy that reads and writes the bytes one bf16 DDIM step at B = 96
    # moves: six bf16 planes and the latents in, the latents out
    n = cs.BATCH * 16 * PRODUCTION["latent_dim"][1]
    nbytes = 6 * n * 2 + 2 * n * 4
    src = torch.ones(nbytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    out["copy_same_bytes"] = times(lambda: dst.copy_(src), (), flush) + (
        device_us(lambda: dst.copy_(src)),)
    for name, key in (("one-element add_ (launch only)", "launch_only"),
                      (f"PyTorch copy of {2 * src.numel() * 4 / 1e6:.2f} MB "
                       f"(the step's bytes)", "copy_same_bytes")):
        cold, warm, dev = out[key]
        log(f"# {name}: cold {cold:.2f} us, back to back {warm:.2f} us, "
            f"device {dev:.2f} us")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-source", type=Path, required=True)
    ap.add_argument("--json", type=Path, help="write the summary here")
    a = ap.parse_args()
    smi = cs.phase_device()
    cs.phase_build()
    base = baseline_step(build_baseline(a.baseline_source))
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    result = {"card": smi,
              "cases": phase_cases(base, flush),
              "in_path": phase_in_path(base),
              "floor": phase_floor(flush)}
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps({"in_path": result["in_path"],
                      "median_new_cold_us": statistics.median(
                          t for r in result["cases"].values()
                          for t in r["new"]["cold_us"])}))


if __name__ == "__main__":
    sys.exit(main())
