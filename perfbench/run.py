"""One run of one benchmark cell on the card; the last line of standard
output is the result as one JSON object.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics with the device's busy time and a breakdown.  Every run
checks what its timed path produced against the plain fp32 reference
(``perfbench/reference``) and prints each compared number beside its
limit.  Without a card, or with fewer than the cell asks for, the run
fails and prints no result.
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
# the program's build and kernel caches, at fixed paths in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".perfbench" / "cache" / sub)
os.environ["USE_FLAX"] = "0"
# the harness is the package ``perfbench``: its own directory, which Python
# puts first for a script, comes off the path, so that none of its module
# names can hide another module
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]


def _host_cpu():
    """(steal, total) clock ticks of all the machine's CPUs since boot
    (/proc/stat; 0 where the file is missing), this process's CPU
    seconds, and the host clock."""
    steal = total = 0
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        steal, total = (ticks[7] if len(ticks) > 7 else 0), sum(ticks[:8])
    except OSError:
        pass
    return steal, total, time.process_time(), time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    import torch

    bench = harness.manifest()
    cell = harness.workload(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.Context(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device="cuda",
        config=harness.config(cell["config"], bench),
        traffic=harness.traffic(cell["traffic"]),
        workdir=harness.scratch_dir(), t_start=T_START)
    host0 = _host_cpu()
    out = harness.run(ctx)
    host1 = _host_cpu()
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    rec = out["rec"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": out["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": out["metrics"],
              "device": device}
    if ctx.trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    checks = {k: {"value": c["value"], "limit": c["limit"]}
              for k, c in out["checks"].items()}
    result["checks"] = checks
    units = sorted(rec["unit_s"])
    print(f"perfbench: {len(units)} calls or steps in the window, host "
          f"seconds each min {units[0]:.4f} median "
          f"{units[len(units) // 2]:.4f} max {units[-1]:.4f}; the reference "
          f"check took {rec['check_s']:.1f} s", file=sys.stderr)
    steal, total = (b - a for a, b in zip(host0[:2], host1[:2]))
    stolen = 100.0 * steal / max(total, 1)
    print(f"perfbench: during the run the machine's CPUs were {stolen:.2f}% "
          f"stolen by the host, the load "
          f"average was {os.getloadavg()[0]:.2f}, and this process used "
          f"{host1[2] - host0[2]:.1f} CPU seconds in "
          f"{host1[3] - host0[3]:.1f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
