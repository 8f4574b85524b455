"""Seeded weights, drawn on the device in a few large calls.

The benchmark makes the weights, not the program: ``draw(specs, seed,
device)`` fills every parameter that ``reference.model.param_specs`` names
from one normal draw of a ``torch.Generator`` on ``device``, scaled by the
parameter's kind (Linear and attention kernels 1/sqrt(fan_in), embedding
rows 1/sqrt(width), norm scales 1 + 0.02 n, biases 0.02 n, the VAE's query
tokens n).  Every value is rounded to bfloat16 once, so it is exact in
the program's bfloat16 weights and in the reference's float32 alike, and
both sides hold the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def scale_and_offset(name: str, shape: tuple) -> Tuple[float, float]:
    """(std, mean) of a parameter's values.  Every 1-D weight is a norm's
    scale; every 2-D one is (fan_out, fan_in) or (rows, width)."""
    if name.endswith("_global_motion_token"):
        return 1.0, 0.0
    if len(shape) == 1:
        return 0.02, 1.0 if name.endswith(".weight") else 0.0
    return 1.0 / math.sqrt(shape[1]), 0.0


def stream(seed: int, purpose: int) -> int:
    """A 63-bit generator seed for one purpose of a run's seed, so that the
    weights, the noise and the draws of one run are independent."""
    return int(np.random.SeedSequence([int(seed), purpose]).generate_state(
        1, np.uint64)[0] >> 1)


def draw(specs: List[Tuple[str, tuple]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """name -> bfloat16 tensor on ``device`` (views of one buffer)."""
    sizes = [math.prod(s) for _, s in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(stream(seed, 0))
    flat = torch.randn(total, generator=gen, device=device)
    so = torch.tensor([scale_and_offset(n, s) for n, s in specs],
                      device=device)
    counts = torch.tensor(sizes, device=device)
    flat = flat * so[:, 0].repeat_interleave(counts, output_size=total) \
        + so[:, 1].repeat_interleave(counts, output_size=total)
    flat = flat.to(torch.bfloat16)
    out, pos = {}, 0
    for (name, shape), n in zip(specs, sizes):
        out[name] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def as_float(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: w.float() for n, w in weights.items()}
