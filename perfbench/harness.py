"""Finds a cell's pieces by name and turns a driver's record into the
result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs[].file``),
a traffic mix (``perfbench/traffic/<traffic>.json``, whose ``driver``
names ``perfbench/drivers/<driver>.py``) and, through the metrics that
list it, a reader each (``perfbench/metrics/<metric>.py``).  The limits of
the numbers a cell compares are ``perfbench/limits/<cell>.json``.  Adding
a cell adds files; none of these functions changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "convofusion_tpu")


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or manifest()
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def driver(name: str):
    return _module("drivers", name)


def reader(metric: str):
    return _module("metrics", metric)


def limits(cell: str) -> Dict[str, Dict]:
    return _json(HERE / "limits" / f"{cell}.json")


def metrics_for(cell: str, traced: bool, bench: Optional[Dict] = None
                ) -> List[Dict]:
    """The cell's end-to-end metrics (``traced`` False: those whose
    ``workloads`` lists it, or every cell's without the key) or its
    per-layer ones (those whose ``workloads`` lists it: the key is
    required there)."""
    bench = bench or manifest()
    if not traced:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", (cell,))]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


@dataclasses.dataclass
class Context:
    """What a driver needs for one run."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: Dict          # the configuration file
    traffic: Dict
    workdir: str          # scratch files, inside the checkout or TMPDIR
    t_start: float        # the process's start on the host clock

    @property
    def cfg(self) -> Dict:
        return self.config["model"]


def judge(readings: Dict[str, float], cell_limits: Dict[str, Dict]
          ) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number that is not finite
    fails, and so does a limit with no reading."""
    out = {}
    for name, lim in cell_limits.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": lim["limit"],
                     "ok": math.isfinite(value) and value <= lim["limit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(ctx: Context) -> Dict:
    """One run of a cell: its driver's record, metrics and checks."""
    rec = driver(ctx.traffic["driver"]).run(ctx)
    rec.update(cfg=ctx.cfg, dtype=ctx.config["compute_dtype"],
               stage=ctx.traffic.get("stage"))
    metrics = {}
    for m in metrics_for(ctx.workload, ctx.trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = judge(rec["readings"], limits(ctx.workload))
    return {"rec": rec, "metrics": metrics, "checks": checks,
            "correct": all(c["ok"] for c in checks.values())
            and rec["failed"] == 0}


def scratch_dir() -> str:
    """TMPDIR's ``perfbench`` directory, else the checkout's ``.perfbench``:
    fixed paths, private to a run's environment and checkout."""
    base = os.environ.get("TMPDIR") or str(ROOT / ".perfbench")
    path = os.path.join(base, "perfbench")
    os.makedirs(path, exist_ok=True)
    return path
