"""Sampler quality on trained weights: do the fast samplers reproduce the
paired training motions as well as DDIM-50 does?

Port of ``scripts/sampler_quality.py::trained_main``.  On the learning
proof's fixture and its trained stage-2 checkpoint (``train/overfit.py``),
the test CLI dumps the train split with guidance off (the conditional
distribution itself) under DDIM-50, DPM-Solver++ 2M at 20 and 15 steps and
DDPM-1000.  Each sampler gets ``reproduction_metrics`` against the paired
ground truth, and its motion RMSE against the DDIM-50 dump over the DDIM-50
motion's std: the CLI draws each batch's initial noise from ``SEED_VALUE``,
so every dump starts from the same noise, and for the deterministic
integrators the gap is their truncation error.

    python -m convofusion_tpu_torch.train.sampler_quality \\
        --workdir <overfit workdir> --ckpt <stage-2 epoch=<n>.ckpt> \\
        [--device cpu] [--out <json>]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# (name, scheduler variant, steps), in the order they run
SAMPLERS = (
    ("ddim50", "ddim", 50),
    ("dpmpp20", "dpmpp_2m", 20),
    ("dpmpp15", "dpmpp_2m", 15),
    ("ddpm1000", "ddpm", 1000),
)


def trained_main(workdir, ckpt, device=None, samplers=SAMPLERS):
    """The protocol above; returns {name: {'repro': ...,
    'motion_rmse_vs_ddim50_over_std': ..., 'seconds': ...}}."""
    from convofusion_tpu_torch.cli.test import main as test_main
    from convofusion_tpu_torch.train.overfit import (
        reproduction_metrics,
        write_cfg,
    )

    beat = os.path.join(workdir, "beat")
    dnd = os.path.join(workdir, "dnd")
    if not (os.path.isdir(beat) and os.path.isfile(ckpt)):
        raise FileNotFoundError(f"no fixture under {workdir} or no "
                                f"checkpoint {ckpt}")
    dev_args = [] if device is None else ["--device", str(device)]

    def dump(variant, steps):
        cfgr, assetsr = write_cfg(
            workdir, beat, dnd, f"squal_{variant}_{steps}",
            stage="diffusion", epochs=1, batch=8, lr=1e-3, scale="small",
            infer_steps=steps,
            extra={"TEST": {"CHECKPOINTS": ckpt},
                   "model": {"guidance_scale": 1.0,
                             "scheduler": {
                                 "variant": variant,
                                 "num_inference_timesteps": steps}}})
        d = test_main(["--cfg", cfgr, "--cfg_assets", assetsr]
                      + dev_args).out_dir
        dirs = sorted(p for p, _, fs in os.walk(d) if "pred.npy" in fs)
        return d, np.stack([np.load(os.path.join(p, "pred.npy"))
                            for p in dirs])

    out, preds = {}, {}
    for name, variant, steps in samplers:
        t0 = time.perf_counter()
        d, p = dump(variant, steps)
        preds[name] = p.astype(np.float64)
        out[name] = {"repro": reproduction_metrics(d),
                     "seconds": time.perf_counter() - t0}
        print(f"# {name}: {out[name]['repro']}", file=sys.stderr)

    ref = preds[samplers[0][0]]
    std = ref.std()
    for name in out:
        out[name]["motion_rmse_vs_ddim50_over_std"] = round(float(
            np.sqrt(((preds[name] - ref) ** 2).mean()) / std), 4)
    return out


def main(argv=None):
    from convofusion_tpu_torch.train.overfit import COMPUTE_DTYPE, card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True,
                    help="the learning proof's workdir (fixture inside)")
    ap.add_argument("--ckpt", required=True,
                    help="its stage-2 checkpoint, epoch=<n>.ckpt")
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the card)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    out = trained_main(args.workdir, args.ckpt, args.device)
    out["card"] = card_line(args.device)
    out["compute_dtype"] = COMPUTE_DTYPE
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()
