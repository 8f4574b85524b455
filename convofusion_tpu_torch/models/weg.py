"""Word-Excitation Guidance (WEG): test-time refinement of the latents
toward attention on the listener's focus words.

Port of ``convofusion_tpu/models/weg.py:34-170`` (reference
``convofusion/models/tools/word_excitation_guidance.py`` and the loop in
``convofusion/models/modeltype/convofusion.py:298-388,437-496``), plus the
per-step schedule that ``convofusion_tpu/models/convofusion.py:685-713``
builds inline.  Focus-word token columns arrive as a static (B, K) index
array with a validity mask; the [1, eot) text region is a softmax mask;
the smoothing reflect-pads at the region's boundary, as the reference does
on its sliced map.  The refinement is a Python loop with the JAX
``lax.while_loop``'s bound: each iteration reads the loss on the host.

Only the latents carry a graph: ``value_and_grad`` differentiates the loss
with ``torch.autograd.grad`` under ``torch.enable_grad``, inside callers
that run under ``torch.no_grad``.  Every op on that graph has a
deterministic backward on the card, so one request gives the same motion
from run to run, as JAX's does: the column gathers are products with one-hot
selection matrices (a gather's backward is a scatter-add with atomics), the
reflect padding is a concatenation of flipped slices (``F.pad``'s reflect
backward adds with atomics) and the 3x3 smoothing is nine weighted shifted
slices (no cuDNN convolution, whose backward algorithm may not be).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from convofusion_tpu_torch.ops.smoothing import gaussian_kernel_2d

_BIG_NEG = -1e9


def select_columns(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``p[b, :, idx[b, k]]`` for p (B, Tq, Tk) and idx (B, K): a product
    with the (B, Tk, K) one-hot selection matrix.  Each output sums one
    value and zeros, so it equals the gather exactly, and its backward is a
    second product, with no scatter-add."""
    cols = torch.arange(p.shape[2], device=p.device)
    onehot = idx.long()[:, None, :] == cols[None, :, None]
    return torch.bmm(p, onehot.to(p.dtype))


def sliced_reflect_smooth(p: torch.Tensor, eot_idx: torch.Tensor,
                          kernel_size: int = 3,
                          sigma: float = 0.5) -> torch.Tensor:
    """Gaussian-smooth the [1, eot) column slice of ``p`` (B, Tq, Tk) with
    reflect padding at the slice boundary.

    The reflect ring is one column each side of the slice (3x3 kernel):
    column 2 is selected into column 0 and column eot-2 into column eot,
    the rows are reflect-padded, the columns zero-padded, and the kernel's
    weighted shifted slices are summed over the full map; columns outside
    [1, eot) are zeroed."""
    _, tq, tk = p.shape
    j = torch.arange(tk, device=p.device)[None, :]
    eot = eot_idx[:, None].long()
    src = torch.where(j == 0, 2, torch.where(j == eot, eot - 2, j))
    p_ext = select_columns(p, src.clamp(0, tk - 1))
    pad = kernel_size // 2
    x = torch.cat([p_ext[:, 1:pad + 1].flip(1), p_ext,
                   p_ext[:, tq - pad - 1:tq - 1].flip(1)], dim=1)
    # the sum in fp32, rounded once, as a bf16 convolution accumulates
    x = F.pad(x.float(), (pad, pad))
    k = gaussian_kernel_2d(kernel_size, sigma)
    out = None
    for di in range(kernel_size):
        for dj in range(kernel_size):
            term = float(k[di, dj]) * x[:, di:di + tq, dj:dj + tk]
            out = term if out is None else out + term
    region = (j >= 1) & (j < eot)
    return out.to(p.dtype) * region[:, None, :]


def aggregate_attentions(att_mats: torch.Tensor) -> torch.Tensor:
    """(B, layers, Tq, Tk) -> (B, Tq, Tk) mean over layers."""
    return att_mats.mean(dim=1)


def max_attention_at_indices(att: torch.Tensor, focus_idx: torch.Tensor,
                             focus_valid: torch.Tensor,
                             eot_idx: torch.Tensor, smooth: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """att (B, Tq, Tk) aggregated tlsn attention; focus_idx (B, K) token
    columns; eot_idx (B,) index of the <eos> token.  Softmax over the
    [1, eot) region, optional smoothing, then the max over motion tokens
    at each focus column.  Returns (max_att (B, K), focus_valid)."""
    tk = att.shape[2]
    pos = torch.arange(tk, device=att.device)
    region = (pos[None, :] >= 1) & (pos[None, :] < eot_idx[:, None])
    p = torch.softmax(att.masked_fill(~region[:, None, :], _BIG_NEG), dim=-1)
    p = p * region[:, None, :]
    if smooth:
        p = sliced_reflect_smooth(p, eot_idx, kernel_size=3, sigma=0.5)
    cols = select_columns(p, focus_idx)
    # amax splits the gradient between tied maxima, as jnp.max does
    return cols.amax(dim=1), focus_valid


def attention_focus_loss(max_att: torch.Tensor,
                         focus_valid: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the mean over valid focus tokens of
    max(0, 1 - att); samples without focus words contribute 0."""
    zero = torch.zeros((), dtype=max_att.dtype, device=max_att.device)
    token_losses = torch.maximum(zero, 1.0 - max_att) * focus_valid
    counts = focus_valid.sum(dim=-1)
    per_sample = torch.where(
        counts > 0, token_losses.sum(dim=-1) / counts.clamp(min=1), 0.0)
    return per_sample.mean()


def make_weg_loss(denoise_text_only: Callable, focus_idx: torch.Tensor,
                  focus_valid: torch.Tensor, eot_idx: torch.Tensor,
                  smooth: bool = True):
    """loss(latents, t), differentiable w.r.t. the latents.
    ``denoise_text_only(latents, t)`` returns the (B, L, Tq, Tk) tlsn
    attention stack of the text-only denoiser pass."""

    def loss_fn(latents, t):
        att = aggregate_attentions(denoise_text_only(latents, t))
        max_att, valid = max_attention_at_indices(
            att, focus_idx, focus_valid, eot_idx, smooth)
        return attention_focus_loss(max_att, valid)

    return loss_fn


def value_and_grad(loss_fn: Callable):
    """(latents, t) -> (loss, d loss / d latents), both detached: a graph
    is built through the latents only, under ``torch.enable_grad``."""

    def fn(latents, t):
        with torch.enable_grad():
            lat = latents.detach().requires_grad_(True)
            loss = loss_fn(lat, t)
            grad, = torch.autograd.grad(loss, lat)
        return loss.detach(), grad

    return fn


def iterative_refinement(loss_and_grad: Callable, latents: torch.Tensor, t,
                         threshold: float, step_size: float,
                         max_refinement_steps: int = 300):
    """``while loss > 1 - threshold`` gradient refinement, at most
    ``max_refinement_steps`` iterations, after one first pass on the
    incoming latents (convofusion_tpu/models/weg.py:155-170).  Each
    iteration's test reads the loss on the host.  Returns (latents, loss,
    iterations)."""
    target = max(0.0, float(np.float32(1.0) - np.float32(threshold)))
    loss, _ = loss_and_grad(latents, t)
    i = 0
    while i < max_refinement_steps and float(loss) > target:
        loss, grad = loss_and_grad(latents, t)
        latents = torch.where(loss > 0, latents - step_size * grad, latents)
        i += 1
    return latents, loss, i


class WegSchedule(NamedTuple):
    """Per reverse step: gradient step size and refinement threshold (-1 =
    none), as fp32 values; and the two iteration bounds."""
    step_sizes: List[float]
    thresholds: List[float]
    max_iter_to_alter: int
    max_refinement_steps: int


def weg_schedule(wp: Dict, n_steps: int) -> WegSchedule:
    """The schedule of ``convofusion_tpu/models/convofusion.py:685-713``
    from a ``weg_parameters`` dict, with its defaults.

    ``scale_schedule`` 'reference' (the default) replays the reference's
    quirk: it reassigns ``scale_range`` inside the step loop
    (convofusion.py:395,436-441: linspace(sr[0], sr[1], n) every
    iteration), so the value used collapses to ~lo at every step and the
    lo -> hi decay never happens.  'linspace' is the decay the parameters
    describe (and the Attend-and-Excite source implements)."""
    scale_factor = float(wp.get("scale_factor", 1000))
    lo, hi = wp.get("scale_range", [1.0, 0.5])
    schedule = str(wp.get("scale_schedule", "reference"))
    if schedule == "reference":
        sr = [float(lo), float(hi)]
        scale_range = np.empty(n_steps, np.float64)
        for i in range(n_steps):
            sr = np.linspace(sr[0], sr[1], n_steps)
            scale_range[i] = sr[i]
    elif schedule == "linspace":
        scale_range = np.linspace(float(lo), float(hi), n_steps)
    else:
        raise ValueError(f"scale_schedule {schedule!r}: 'reference' or "
                         f"'linspace'")
    step_sizes = (scale_factor * np.sqrt(scale_range)).astype(np.float32)
    thresholds = np.full(n_steps, -1.0, np.float32)
    for i, thr in dict(wp.get("thresholds", {})).items():
        if int(i) < n_steps:
            thresholds[int(i)] = float(thr)
    return WegSchedule([float(v) for v in step_sizes],
                       [float(v) for v in thresholds],
                       int(wp.get("max_iter_to_alter", 800)),
                       int(wp.get("max_refinement_steps", 300)))
