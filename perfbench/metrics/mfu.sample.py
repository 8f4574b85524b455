"""The sampling calls' algorithmic operations (``flops.sample_call``)
over the window's seconds, as a share of the card's bf16 peak."""
from perfbench import flops


def read(rec):
    if "calls" not in rec:
        return None
    rows = rec["clips"] // rec["calls"]
    work = rec["calls"] * flops.sample_call(rec["cfg"], rows)
    return 100.0 * work / rec["window_s"] / flops.PEAK_BF16_FLOPS
