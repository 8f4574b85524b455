"""The control: the fp8 reference in the program's place fails a cell's
limits.  On the card at the cell's own size (what the limits were set
from; ``perfbench/calibrate.py --modes control`` reads it on more seeds);
on the CPU at a tiny size for the training cells.  A tiny sampler's fp8
trajectory stays closer to fp32 than the full-width one does (worst-row
motion gap 0.21-0.33 at width 64 over 50 steps, 0.58-0.62 at the cell's
widths), so the sampling cell's control is held on the card alone."""
import pytest

from perfbench import calibrate
from perfbench import harness
from perfbench.tests import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
TRAIN = [c for c in CELLS if harness.traffic(
    harness.workload(c)["traffic"])["driver"] == "train_loop"]


def failed(cell, readings):
    checks = harness.judge(readings, harness.limits(cell))
    return not all(c["ok"] for c in checks.values())


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_is_not_correct(cell, seed, tmp_path):
    readings = calibrate.stand_in(tiny.context(cell, tmp_path, seed=seed),
                                  "control")
    assert failed(cell, readings), readings


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_at_the_cells_size(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    w = harness.workload(cell)
    ctx = tiny.context(cell, tmp_path, seed=7)
    ctx.device = "cuda"
    ctx.config = harness.config(w["config"])
    ctx.traffic = harness.traffic(w["traffic"])
    assert failed(cell, calibrate.stand_in(ctx, "control"))
