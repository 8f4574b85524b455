"""The numbers each run compares with the plain fp32 reference.

Run after the window, once the program's state is freed, with TF32 off.
The reference gets what the benchmark made (weights, texts, mels, ids,
noise, draws) and tokenizes the texts itself; it reads the program's
outputs only to judge them.

Sampling: the worst row's relative L2 gap, and that of all checked rows
together, of the final latents against the reference's trajectory, of the
motion against the reference's, and of the motion against the
reference's decode of the program's own latents.  Training, over the first ``checked_steps`` steps, whose dropout masks
both sides draw from one generator seeded from the run's seed: the worst
step's relative loss gap; the first gradient's per-leaf norm as the
optimizer holds it (its first moment / (1 - b1)); each leaf's change of
the fp32 master weights after the first step (where the bfloat16 weights
still follow them) and after the checked steps.  A norm gap is |program - reference| over the larger of
the reference's norm of that leaf and of the median leaf.  An element
whose reference gradient is under a thousandth of the median leaf's RMS
gradient (a key's bias under softmax, packed with the query and value
biases in one leaf) moves under Adam by rounding alone: the change leaves
it out, on both sides.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from perfbench import weights as W

ADAM_B1 = 0.9
SILENT_GRADIENT = 1e-3


def fp32_matmuls():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def reference_inputs(tok, raw: Dict, pad_to: int, device) -> Dict:
    """The reference's tensors of a host batch; texts tokenized by the
    reference's own tokenizer."""
    import torch

    b = len(next(v for v in raw.values()))
    out = {}
    if "text_lsn" in raw:
        for side in ("spk", "lsn"):
            ids, valid = tok(raw[f"text_{side}"], pad_to)
            out[f"{side}_ids"] = torch.from_numpy(ids).to(device)
            out[f"{side}_valid"] = torch.from_numpy(valid).to(device)
        ids, valid = tok(["-" * 10] * b, pad_to)
        out["uncond_ids"] = torch.from_numpy(ids).to(device)
        out["uncond_valid"] = torch.from_numpy(valid).to(device)
    for k in ("mel", "motion"):
        if k in raw:
            out[k] = torch.from_numpy(raw[k]).to(device)
    for k in ("apb", "lsn_id"):
        if k in raw:
            out[k] = torch.from_numpy(raw[k]).long().to(device)
    return out


def gaps(got, want) -> Dict[str, float]:
    """The worst row's relative L2 gap and that of all rows together."""
    got, want = got.float().to(want.device), want.float()
    diff = (got - want).flatten(1).norm(dim=1)
    rows = want.flatten(1).norm(dim=1)
    return {"worst_row": float((diff / rows).max()),
            "rel_rms": float(diff.norm() / rows.norm())}


def sample_readings(ctx, weights, raws: Sequence[Dict], noises,
                    outputs: Sequence, spiece: str, lowp=None,
                    block: int = 96) -> Dict:
    """``outputs[i]`` = (motion on the host, latents) of the program for
    ``raws[i]`` and ``noises[i]``.  The reference samples every checked
    row from the same inputs (``block`` rows at a time), and decodes the
    program's own latents: the trajectory and the decode are judged each
    by itself."""
    import torch

    from perfbench.reference import model as R
    from perfbench.reference.tokenizer import Tokenizer

    fp32_matmuls()
    ref = R.Ref(W.as_float(weights), ctx.cfg, lowp)
    tok = Tokenizer(spiece)
    dev = noises[0].device
    ins = [reference_inputs(tok, raw, int(ctx.cfg["text_pad_len"]), dev)
           for raw in raws]
    inputs = {k: torch.cat([i[k] for i in ins]) for k in ins[0]}
    motion = torch.cat([m.float().to(dev) for m, _ in outputs])
    latents = torch.cat([lat.float().to(dev) for _, lat in outputs])
    rm, rl = R.sample(ref, inputs, torch.cat(list(noises)), block=block)
    rd = torch.cat([R.decode(ref, latents[lo:lo + block])
                    for lo in range(0, len(latents), block)])
    out = {}
    for k, got, want in (("motion", motion, rm), ("latent", latents, rl),
                         ("decode", motion, rd)):
        out.update({f"{k}_{g}": v for g, v in gaps(got, want).items()})
    return out


def norm_gap(got: Sequence[float], want: Sequence[float]) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    floor = np.maximum(want, np.median(want))
    return float(np.max(np.abs(got - want) / floor))


def train_readings(ctx, weights, stage: str, raws: Sequence[Dict],
                   draws: Sequence[Dict], program: Dict, spiece: str,
                   mask_seed: int, lowp=None) -> Dict:
    """``program``: 'losses' of the checked steps, 'grad_norms' by leaf
    name, 'change1' and 'change' (each leaf's change after the first and
    the last checked step, a tensor) by leaf name, 'window_loss' (the last
    window step's)."""
    from perfbench.reference import model as R
    from perfbench.reference.tokenizer import Tokenizer

    fp32_matmuls()
    device = next(iter(weights.values())).device
    tok = Tokenizer(spiece)
    batches = [reference_inputs(tok, raw, int(ctx.cfg["text_pad_len"]),
                                device) for raw in raws]
    losses, grads, change1, change = R.adamw_steps(
        W.as_float(weights), ctx.cfg, stage, batches, draws, lowp, mask_seed)
    return compare_training(program, losses, grads, change1, change)


def compare_training(program: Dict, losses: List[float], grads: Dict,
                     change1: Dict, change: Dict) -> Dict:
    names = sorted(grads)
    g_ref = [float(grads[n].norm()) for n in names]
    rms = np.median([g / math.sqrt(grads[n].numel())
                     for n, g in zip(names, g_ref)])
    masks = {n: grads[n].abs() >= SILENT_GRADIENT * rms for n in names}
    moving = [n for n in names if bool(masks[n].any())]
    gaps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], losses)]
    def norms(got, want):
        return (np.array([float(got[n].to(want[n].device)[masks[n]].norm())
                          for n in moving]),
                np.array([float(want[n][masks[n]].norm()) for n in moving]))

    c1_prog, c1_ref = norms(program["change1"], change1)
    c_prog, c_ref = norms(program["change"], change)
    window = float(program["window_loss"])
    return {
        "loss_gap_step1": gaps[0],
        "loss_gap": max(gaps),
        "grad_norm_gap": norm_gap([program["grad_norms"][n] for n in names],
                                  g_ref),
        "change1_norm_gap": norm_gap(c1_prog, c1_ref),
        "change_norm_gap": norm_gap(c_prog, c_ref),
        "change_median_gap": float(np.median(np.abs(c_prog - c_ref) / c_ref)),
        "window_loss_not_finite": 0.0 if np.isfinite(window) else 1.0,
    }
