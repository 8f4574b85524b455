"""WEG's deterministic forms against the gather forms they replaced.

``models/weg.py`` selects columns with one-hot products, reflect-pads with
flipped slices and smooths with nine weighted shifted slices, so the card's
backward has no atomics.  Here, on the CPU, its ``sliced_reflect_smooth``
and ``max_attention_at_indices`` (values, and gradients through the focus
loss WEG differentiates) are held to the earlier forms (``torch.gather``,
``F.pad(mode='reflect')``, ``F.conv2d``), copied below, within 1e-7: the
one-hot products are exact, and the smoothing sums the same nine products
of values in [0, 1] in another order (observed <= 9e-8).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convofusion_tpu_torch.models import weg
from convofusion_tpu_torch.ops.smoothing import gaussian_kernel_2d

TOL = 1e-7
TK = 16


def gather_smooth(p, eot_idx, kernel_size=3, sigma=0.5):
    """The gather + reflect pad + conv2d form of sliced_reflect_smooth."""
    b, tq, tk = p.shape
    j = torch.arange(tk)[None, :]
    eot = eot_idx[:, None].long()
    src = torch.where(j == 0, 2, torch.where(j == eot, eot - 2, j))
    src = src.clamp(0, tk - 1)
    p_ext = torch.gather(p, 2, src[:, None, :].expand(b, tq, tk))
    k = torch.as_tensor(gaussian_kernel_2d(kernel_size, sigma),
                        dtype=p.dtype)
    pad = kernel_size // 2
    x = F.pad(p_ext, (0, 0, pad, pad), mode="reflect")
    x = F.pad(x, (pad, pad))
    out = F.conv2d(x[:, None], k[None, None])[:, 0]
    return out * ((j >= 1) & (j < eot))[:, None, :]


def gather_max_attention(att, focus_idx, focus_valid, eot_idx):
    """max_attention_at_indices with the gather forms."""
    b, tq, tk = att.shape
    pos = torch.arange(tk)
    region = (pos[None, :] >= 1) & (pos[None, :] < eot_idx[:, None])
    p = torch.softmax(att.masked_fill(~region[:, None, :], -1e9), dim=-1)
    p = gather_smooth(p * region[:, None, :], eot_idx)
    idx = focus_idx.long()
    cols = torch.gather(p, 2, idx[:, None, :].expand(b, tq, idx.shape[1]))
    return cols.amax(dim=1), focus_valid


def _case(seed):
    g = torch.Generator().manual_seed(seed)
    att = torch.randn(4, 16, TK, generator=g) * 3.0
    eot = torch.tensor([TK - 1, 9, 4, 3])
    idx = torch.randint(0, TK, (4, 5), generator=g)
    valid = (torch.rand(4, 5, generator=g) > 0.3).float()
    return att, idx, valid, eot


def _softmax_map(att, eot):
    pos = torch.arange(att.shape[2])
    region = (pos[None, :] >= 1) & (pos[None, :] < eot[:, None])
    p = torch.softmax(att.masked_fill(~region[:, None, :], -1e9), dim=-1)
    return p * region[:, None, :]


@pytest.mark.parametrize("seed", range(4))
def test_smooth_matches_the_gather_form(seed):
    att, _, _, eot = _case(seed)
    outs = []
    for fn in (weg.sliced_reflect_smooth, gather_smooth):
        a = att.clone().requires_grad_(True)
        out = fn(_softmax_map(a, eot), eot)
        # an upstream weight of the map's own scale: what the focus loss
        # sends back through a max over the motion tokens
        w = torch.rand(out.shape, generator=torch.Generator().manual_seed(
            seed)) / out.shape[1]
        grad, = torch.autograd.grad((out * w).sum(), a)
        outs.append((out.detach(), grad))
    (v_new, g_new), (v_old, g_old) = outs
    assert float((v_new - v_old).abs().max()) <= TOL
    assert float((g_new - g_old).abs().max()) <= TOL


@pytest.mark.parametrize("seed", range(4))
def test_max_attention_and_focus_loss_match_the_gather_form(seed):
    att, idx, valid, eot = _case(seed)
    outs = []
    for fn in (weg.max_attention_at_indices, gather_max_attention):
        a = att.clone().requires_grad_(True)
        max_att, v = fn(a, idx, valid, eot)
        loss = weg.attention_focus_loss(max_att, v)
        grad, = torch.autograd.grad(loss, a)
        outs.append((max_att.detach(), loss.detach(), grad))
    (m_new, l_new, g_new), (m_old, l_old, g_old) = outs
    assert float((m_new - m_old).abs().max()) <= TOL
    assert abs(float(l_new - l_old)) <= TOL
    assert float((g_new - g_old).abs().max()) <= TOL


def test_select_columns_is_the_gather_exactly():
    g = torch.Generator().manual_seed(5)
    p = torch.rand(3, 7, TK, generator=g)
    idx = torch.randint(0, TK, (3, 4), generator=g)
    want = torch.gather(p, 2, idx[:, None, :].expand(3, 7, 4))
    assert torch.equal(weg.select_columns(p, idx), want)
    # a column picked twice gets both gradients back
    idx[:, 1] = idx[:, 0]
    a = p.clone().requires_grad_(True)
    weg.select_columns(a, idx).sum().backward()
    counts = np.zeros((3, TK))
    for b in range(3):
        for k in idx[b].tolist():
            counts[b, k] += 1
    assert np.array_equal(a.grad[:, 0].numpy(), counts)
