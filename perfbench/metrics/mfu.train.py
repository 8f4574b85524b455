"""The training steps' algorithmic operations (``flops.train_step``) over
the window's seconds, as a share of the card's bf16 peak."""
from perfbench import flops


def read(rec):
    if "steps" not in rec:
        return None
    rows = rec["train_rows"] // rec["steps"]
    work = rec["steps"] * flops.train_step(rec["cfg"], rec["stage"], rows)
    return 100.0 * work / rec["window_s"] / flops.PEAK_BF16_FLOPS
