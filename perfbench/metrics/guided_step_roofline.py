"""The fused guidance + DDIM step kernel's least time, its bytes
(``flops.guided_step_bytes``) over HBM bandwidth, as a share of its mean
device time in the profiled call.  Silent where no such kernel ran."""
from perfbench import flops

NAME = "guided_step_kernel"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    hits = [(n, s) for name, (n, s) in tr["kernels"].items() if NAME in name]
    count = sum(n for n, _ in hits)
    if not count:
        return None
    seconds = sum(s for _, s in hits) / count
    cfg = rec["cfg"]
    rows = rec["clips"] // rec["calls"]
    tokens = 2 * int(cfg["max_len"]) // flops.VAE_CHUNK
    nbytes = flops.guided_step_bytes(rows, tokens, int(cfg["latent_dim"][1]),
                                     2 if rec["dtype"] == "bfloat16" else 4)
    return 100.0 * nbytes / flops.PEAK_HBM_BYTES_PER_S / seconds
