"""The readings a cell's limits are set from, on the card at the cell's
size: the program's (short runs of the cell; ``program_fp32`` with the compute
dtype float32, a witness of the program's arithmetic), the control's (the fp8
reference in the program's place) and, for a training cell, a planted
fault's (the fp32 reference in the program's place, its loss the mean
over half of each batch).  The benchmark's own runs never run this.

    python perfbench/calibrate.py --workload <cell> --modes program,control \
        --seeds 1,2,3 [--seconds 2] [--out readings.jsonl]

Prints one JSON line per mode and seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".perfbench" / "cache" / sub)
# the harness is the package ``perfbench``: its own directory, which Python
# puts first for a script, comes off the path, so that none of its module
# names can hide another module
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]

MODES = ("program", "program_fp32", "control", "half_batch")


def _half(batch, draws):
    """Each tensor's first half of the batch rows (the VAE noise keeps its
    leading part axis)."""
    b = len(next(iter(batch.values())))
    h = b // 2
    cut = {k: v[:h] for k, v in batch.items()}
    d = {k: (v[:, :h] if k == "eps" else v[:h]) for k, v in draws.items()}
    return cut, d


def stand_in(ctx, mode: str):
    """The readings with the reference, in ``mode``, put in the program's
    place on the cell's inputs."""
    import torch

    from perfbench import checks
    from perfbench import harness
    from perfbench import weights as W
    from perfbench.reference import model as R
    from perfbench.reference.tokenizer import Tokenizer, write_spiece

    dev = torch.device(ctx.device)
    spiece = write_spiece(f"{ctx.workdir}/spiece.model")
    checks.fp32_matmuls()
    tok = Tokenizer(spiece)
    pad = int(ctx.cfg["text_pad_len"])
    driver = harness.driver(ctx.traffic["driver"])
    if ctx.traffic["driver"] == "sample_loop":
        if mode != "control":
            raise ValueError(f"{mode} is a training fault")
        weights, pool, noises = driver.inputs(ctx, dev)
        chosen = driver.checked(ctx, range(len(pool)))
        ref = R.Ref(W.as_float(weights), ctx.cfg, "fp8")
        ins = [checks.reference_inputs(tok, pool[k], pad, dev)
               for k in chosen]
        m, lat = R.sample(ref, {k: torch.cat([i[k] for i in ins])
                                for k in ins[0]},
                          torch.cat([noises[k] for k in chosen]), block=96)
        return checks.sample_readings(ctx, weights,
                                      [pool[k] for k in chosen],
                                      [noises[k] for k in chosen],
                                      [(m.cpu(), lat)], spiece)
    weights, pool, draws = driver.inputs(ctx, dev)
    n = int(ctx.traffic["checked_steps"])
    stage = ctx.traffic["stage"]
    batches = [checks.reference_inputs(tok, raw, pad, dev)
               for raw in pool[:n]]
    drs = draws[:n]
    if mode == "half_batch":
        pairs = [_half(b, d) for b, d in zip(batches, drs)]
        batches, drs = [p[0] for p in pairs], [p[1] for p in pairs]
    seed = driver.mask_seed(ctx)
    losses, grads, change1, change = R.adamw_steps(
        W.as_float(weights), ctx.cfg, stage, batches, drs,
        "fp8" if mode == "control" else None, seed)
    program = {"losses": losses,
               "grad_norms": {k: float(g.norm()) for k, g in grads.items()},
               "change1": change1, "change": change,
               "window_loss": losses[-1]}
    return checks.train_readings(ctx, weights, stage, pool[:n], draws[:n],
                                 program, spiece, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    bench = harness.manifest()
    cell = harness.workload(args.workload, bench)
    out = open(args.out, "a") if args.out else None
    for mode in args.modes.split(","):
        if mode not in MODES:
            raise SystemExit(f"mode {mode!r}, not one of {MODES}")
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            ctx = harness.Context(
                workload=args.workload, seed=seed, seconds=args.seconds,
                trace=False, device="cuda",
                config=harness.config(cell["config"], bench),
                traffic=harness.traffic(cell["traffic"]),
                workdir=harness.scratch_dir(), t_start=t)
            if mode.startswith("program"):
                if mode == "program_fp32":
                    ctx.config = {**ctx.config, "compute_dtype": "float32"}
                rec = harness.run(ctx)["rec"]
                readings = {**rec["readings"], **rec.get("diagnostics", {})}
            else:
                readings = stand_in(ctx, mode)
            line = json.dumps({"workload": args.workload, "mode": mode,
                               "seed": seed, "readings": readings,
                               "seconds": time.perf_counter() - t,
                               "card": torch.cuda.get_device_name(0)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
