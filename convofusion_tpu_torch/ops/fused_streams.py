"""Fused five-stream cross-attention.

Port of ``convofusion_tpu/ops/fused_streams.py:1-178``.  The denoiser layer
runs five single-head cross-attentions, one a condition stream; this module
computes the same math as one batched attention over a (streams, B, Tmax,
D) padded memory stack: a per-stream memory LayerNorm, per-stream q/k/v/out
projections stacked along a leading stream axis, and separate softmaxes
through the pad mask.

The parameters keep JAX's layout and names: ``ln_scale`` / ``ln_bias`` (S,
D), ``{q,k,v,o}_kernel`` (S, D_in, D_out) and ``{q,k,v,o}_bias`` (S, D),
fp32 in every compute dtype, as flax keeps them; the math runs in fp32 and
the attention weights are rounded to the compute dtype before they meet
the values, as JAX's type promotion does.  ``fuse_*`` convert the unfused
layer's weights (the port's state-dict names) into this layout and
``unfuse_*`` convert back, so a fused model is held against the unfused
one on the same weights.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from convofusion_tpu_torch.ops.attention import _BIG_NEG, _sqrt_in
from convofusion_tpu_torch.ops.layers import Dropout
from convofusion_tpu_torch.ops.transformer import COND_STREAMS as STREAMS

PROJECTIONS = ("q", "k", "v", "o")


def pad_stream_stack(memory: Dict[str, torch.Tensor],
                     masks: Optional[Dict[str, torch.Tensor]]
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, int]]:
    """Each stream's memory padded to the longest and stacked, once a
    denoiser call for every layer (JAX :34-55).  A single-row stream (1,
    Tk, D) or mask (1, Tk), the shared uncond rows of the WEG text-only
    pass, is broadcast to the batch.  Returns (mem (S, B, Tmax, D), pad (S,
    B, Tmax) True = pad, each stream's length)."""
    masks = masks or {}
    lengths = {s: memory[s].shape[1] for s in STREAMS}
    t_max = max(lengths.values())
    b = max(memory[s].shape[0] for s in STREAMS)
    mems, pads = [], []
    for s in STREAMS:
        m = memory[s]
        t = m.shape[1]
        mems.append(F.pad(m, (0, 0, 0, t_max - t)).expand(b, -1, -1))
        base = masks.get(s)
        if base is None:
            base = torch.zeros((1, t), dtype=torch.bool, device=m.device)
        pads.append(F.pad(base, (0, t_max - t), value=True).expand(b, -1))
    return torch.stack(mems), torch.stack(pads), lengths


class FusedCrossStreams(nn.Module):
    """Batched per-stream LayerNorm + single-head cross-attention + out
    projection (JAX :58-125)."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        s, d = len(STREAMS), d_model
        self.d_model = d
        self.dtype = dtype
        self.ln_scale = nn.Parameter(torch.ones(s, d))
        self.ln_bias = nn.Parameter(torch.zeros(s, d))
        for p in PROJECTIONS:
            kernel = torch.empty(s, d, d)
            for i in range(s):
                nn.init.xavier_uniform_(kernel[i])
            setattr(self, f"{p}_kernel", nn.Parameter(kernel))
            setattr(self, f"{p}_bias", nn.Parameter(torch.zeros(s, d)))
        self.attn_dropout = Dropout(dropout)

    def _proj(self, x, name, spec):
        return (torch.einsum(spec, x, getattr(self, f"{name}_kernel"))
                + getattr(self, f"{name}_bias")[:, None, None, :])

    def forward(self, q_in, mem_stack, pad_stack):
        """q_in (B, Tq, D); mem_stack (S, B, Tk, D); pad_stack (S, B, Tk).
        Returns (concat (B, Tq, S*D) in stream order, fp32; weights (S, B,
        Tq, Tk) in the compute dtype, before dropout)."""
        mem = F.layer_norm(mem_stack.float(), (self.d_model,), eps=1e-5)
        mem = mem * self.ln_scale[:, None, None, :] \
            + self.ln_bias[:, None, None, :]
        q = self._proj(q_in.float(), "q", "btd,sde->sbte")
        k = self._proj(mem, "k", "sbtd,sde->sbte")
        v = self._proj(mem, "v", "sbtd,sde->sbte")
        logits = q @ k.transpose(-1, -2) / _sqrt_in(self.d_model, q.dtype)
        logits = logits.masked_fill(pad_stack[:, :, None, :], _BIG_NEG)
        weights = torch.softmax(logits, dim=-1).to(self.dtype)
        out = self.attn_dropout(weights).float() @ v
        out = self._proj(out, "o", "sbqd,sde->sbqe")
        s, b, tq, d = out.shape
        return out.permute(1, 2, 0, 3).reshape(b, tq, s * d), weights


# ------------------------------------------------------ weight converters
def fuse_layer_params(layer: Dict[str, torch.Tensor]) -> Dict[str,
                                                               torch.Tensor]:
    """An unfused layer's cross-section weights (``multihead_attn_<s>.*``,
    ``<s>_norm.*``, the port's names relative to the layer) -> the
    ``FusedCrossStreams`` names, fp32 (JAX :128-156)."""
    d = layer[f"multihead_attn_{STREAMS[0]}.out_proj.weight"].shape[0]

    def stack(fn):
        return torch.stack([fn(s).float() for s in STREAMS])

    def proj(s, i):
        w = layer[f"multihead_attn_{s}.in_proj_weight"][i * d:(i + 1) * d]
        return w.t()

    def proj_bias(s, i):
        return layer[f"multihead_attn_{s}.in_proj_bias"][i * d:(i + 1) * d]

    out = {"ln_scale": stack(lambda s: layer[f"{s}_norm.weight"]),
           "ln_bias": stack(lambda s: layer[f"{s}_norm.bias"])}
    for i, p in enumerate(PROJECTIONS[:3]):
        out[f"{p}_kernel"] = stack(lambda s: proj(s, i))
        out[f"{p}_bias"] = stack(lambda s: proj_bias(s, i))
    out["o_kernel"] = stack(
        lambda s: layer[f"multihead_attn_{s}.out_proj.weight"].t())
    out["o_bias"] = stack(lambda s: layer[f"multihead_attn_{s}.out_proj.bias"])
    return {k: v.contiguous() for k, v in out.items()}


def unfuse_layer_params(fused: Dict[str, torch.Tensor]) -> Dict[str,
                                                                 torch.Tensor]:
    """The inverse of :func:`fuse_layer_params`."""
    out = {}
    for i, s in enumerate(STREAMS):
        out[f"{s}_norm.weight"] = fused["ln_scale"][i]
        out[f"{s}_norm.bias"] = fused["ln_bias"][i]
        out[f"multihead_attn_{s}.in_proj_weight"] = torch.cat(
            [fused[f"{p}_kernel"][i].t() for p in PROJECTIONS[:3]])
        out[f"multihead_attn_{s}.in_proj_bias"] = torch.cat(
            [fused[f"{p}_bias"][i] for p in PROJECTIONS[:3]])
        out[f"multihead_attn_{s}.out_proj.weight"] = \
            fused["o_kernel"][i].t()
        out[f"multihead_attn_{s}.out_proj.bias"] = fused["o_bias"][i]
    return {k: v.contiguous() for k, v in out.items()}


_LAYER = re.compile(r"^(.*decoder\.layers\.\d+\.)(.*)$")
_CROSS = re.compile(r"^(multihead_attn_(" + "|".join(STREAMS) + r")\.|("
                    + "|".join(STREAMS) + r")_norm\.)")
_FUSED = "cross_streams."


def _convert(state_dict: Dict, is_section, convert) -> Dict:
    """Every decoder layer's cross section of ``state_dict`` through
    ``convert``, the other weights as they are."""
    out, sections = {}, {}
    for k, v in state_dict.items():
        m = _LAYER.match(k)
        if m and is_section(m.group(2)):
            sections.setdefault(m.group(1), {})[m.group(2)] = v
        else:
            out[k] = v
    for prefix, section in sections.items():
        out.update({prefix + k: v for k, v in convert(section).items()})
    return out


def fuse_denoiser_params(state_dict: Dict) -> Dict:
    """An unfused model's (or denoiser's) state dict -> the fused layout:
    each decoder layer's five ``multihead_attn_<s>`` / ``<s>_norm`` become
    its ``cross_streams`` (JAX ``fuse_denoiser_params``, :159-178)."""
    return _convert(
        state_dict, lambda name: bool(_CROSS.match(name)),
        lambda sec: {_FUSED + k: v for k, v in fuse_layer_params(sec).items()})


def unfuse_denoiser_params(state_dict: Dict) -> Dict:
    """The inverse of :func:`fuse_denoiser_params`."""
    return _convert(
        state_dict, lambda name: name.startswith(_FUSED),
        lambda sec: unfuse_layer_params(
            {k[len(_FUSED):]: v for k, v in sec.items()}))
