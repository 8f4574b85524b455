"""Transformer blocks: the skip decoder of the VAE and the five-stream
conditional decoder layer of the denoiser.

Port of ``convofusion_tpu/ops/transformer.py``: ``_FFN``, ``TimeBlock``,
``TransformerDecoderLayer``, ``SkipTransformerDecoder`` (:38-53,96-145,
189-252), ``TransformerDecoderLayer2Att.__call__`` / ``.forward_mem`` /
``.guided`` (:255-347,404-510), ``DenoiserDecoder.__call__`` /
``.forward_mem`` / ``.guided`` (:513-565,573-589,609-627) and the guidance
tables (:26,732-750).  ``forward`` here is both ``__call__`` and
``forward_mem``: its cross-attention broadcasts single-row memories, so
one body serves full and mixed-batch streams.  Inference only:
dropout is the identity and is left out.  No caller passes positional
queries inside the layers (``pos``/``query_pos`` are always None on the
sampling path), so those arguments are left out too.

Module and parameter names are the reference torch ones (``linear1`` /
``linear2`` on the layer, ``time_block1.emb_layers.1``,
``multihead_attn_{stream}``, ``input_blocks.{i}``), the names that
``convofusion_tpu/compat/torch_loader.py`` maps.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from convofusion_tpu_torch.ops.attention import MultiheadAttention
from convofusion_tpu_torch.ops.layers import LayerNorm, Linear

# the five conditioning streams, in fuser concat order
COND_STREAMS = ("spkemb", "alsn", "tlsn", "apb", "lsnemb")

# guidance branch -> condition streams kept real:
# [all_drop, text, audio, spk, apb, lsnid, full]
GUIDANCE_BRANCHES = (
    (),
    ("tlsn",),
    ("alsn",),
    ("spkemb",),
    ("apb",),
    ("lsnemb",),
    ("spkemb", "alsn", "tlsn", "apb", "lsnemb"),
)
NUM_BRANCHES = len(GUIDANCE_BRANCHES)
# per stream: sorted branch indices using the REAL variant (the rest use
# uncond); the full-condition branch (6) is always last
REAL_BRANCHES = {
    s: tuple(b for b, streams in enumerate(GUIDANCE_BRANCHES)
             if s in streams)
    for s in COND_STREAMS
}


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu          # exact erf form, as flax approximate=False
    raise ValueError(f"activation should be relu/gelu, not {name}")


class _FFN(nn.Module):
    """linear1 -> activation -> linear2.  A mixin: the reference keeps
    ``linear1``/``linear2`` directly on the layer, not under ``ffn``."""

    def _init_ffn(self, d_model, dim_feedforward, activation, dtype):
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.act = _activation(activation)

    def ffn(self, x):
        return self.linear2(self.act(self.linear1(x)))


class TransformerDecoderLayer(_FFN):
    """Pre-norm decoder layer (the production VAE, modules/motion_vae.yaml);
    the post-norm ablation is not ported."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("post-norm decoder layers are not "
                                      "ported")
        self.self_attn = MultiheadAttention(d_model, nhead, dtype)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dtype)
        self._init_ffn(d_model, dim_feedforward, activation, dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory):
        tgt2 = self.norm1(tgt)
        tgt2, _ = self.self_attn(tgt2, tgt2, tgt2, need_weights=False)
        tgt = tgt + tgt2
        tgt2, _ = self.multihead_attn(self.norm2(tgt), memory, memory,
                                      need_weights=False)
        tgt = tgt + tgt2
        return tgt + self.ffn(self.norm3(tgt))


class SkipTransformerDecoder(nn.Module):
    """U-Net-style decoder stack: (n-1)/2 in-blocks, middle, (n-1)/2
    out-blocks with Linear(2d->d) skip merges."""

    def __init__(self, d_model: int, num_layers: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_layers % 2 != 1:
            raise ValueError("SkipTransformerDecoder needs an odd depth")
        num_block = (num_layers - 1) // 2

        def layer():
            return TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                           activation, normalize_before,
                                           dtype)

        self.input_blocks = nn.ModuleList(layer() for _ in range(num_block))
        self.middle_block = layer()
        self.output_blocks = nn.ModuleList(layer() for _ in range(num_block))
        self.linear_blocks = nn.ModuleList(
            Linear(2 * d_model, d_model, dtype=dtype)
            for _ in range(num_block))
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, memory):
        """No padding masks: the VAE's 128 frames and 8 chunks are
        static."""
        x, xs = tgt, []
        for blk in self.input_blocks:
            x = blk(x, memory)
            xs.append(x)
        x = self.middle_block(x, memory)
        for lin, blk in zip(self.linear_blocks, self.output_blocks):
            x = lin(torch.cat([x, xs.pop()], dim=-1))
            x = blk(x, memory)
        return self.norm(x)


class TimeBlock(nn.Module):
    """AdaLN-style timestep modulation; returns the residual delta.

    h (..., T, D); emb (..., 1, D)."""

    def __init__(self, latent_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(latent_dim, 2 * latent_dim, dtype=dtype))
        self.norm = LayerNorm(latent_dim)
        self.out_layers = nn.Sequential(
            nn.SiLU(), nn.Identity(),  # (Dropout in the reference)
            Linear(latent_dim, latent_dim, dtype=dtype))

    def forward(self, h, emb):
        scale, shift = self.emb_layers(emb).chunk(2, dim=-1)
        h = self.norm(h) * (1 + scale) + shift
        return self.out_layers(h)


class TransformerDecoderLayer2Att(_FFN):
    """Denoiser layer (pre-norm): self-attn, TimeBlock, five parallel
    single-head cross-attentions over the condition streams, linear fuser,
    second TimeBlock, FFN.

    ``guided`` runs the seven classifier-free-guidance branches at once:
    the memory-side LayerNorm + K/V run once per variant (real / uncond)
    instead of once per branch."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not normalize_before:
            raise ValueError("the denoiser layer is pre-norm "
                             "(modules/denoiser.yaml)")
        d = d_model
        self.self_attn = MultiheadAttention(d, nhead, dtype)
        self.time_block1 = TimeBlock(d, dtype)
        self.time_block2 = TimeBlock(d, dtype)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)
        for s in COND_STREAMS:
            setattr(self, f"multihead_attn_{s}",
                    MultiheadAttention(d, 1, dtype))
            setattr(self, f"{s}_norm", LayerNorm(d))
            # branch indices as device tensors: indexing with a Python list
            # would copy it to the card on every call
            real = REAL_BRANCHES[s]
            unc = tuple(i for i in range(NUM_BRANCHES) if i not in real)
            self.register_buffer(f"_real_idx_{s}", torch.tensor(real),
                                 persistent=False)
            self.register_buffer(f"_unc_idx_{s}", torch.tensor(unc),
                                 persistent=False)
        self.att_fuser = Linear(len(COND_STREAMS) * d, d, dtype=dtype)
        self._init_ffn(d, dim_feedforward, activation, dtype)

    def _cross(self, s):
        return (getattr(self, f"multihead_attn_{s}"),
                getattr(self, f"{s}_norm"))

    def forward(self, tgt, memory: Dict[str, torch.Tensor], time_embed,
                mem_masks: Optional[Dict[str, torch.Tensor]] = None):
        """tgt (B, Tq, D); memory[stream] (B, Tk_s, D), or single shared
        rows (1, Tk_s, D) that stay at batch 1 through LayerNorm + K/V and
        broadcast inside ``grouped_attend`` (the WEG text-only pass, where
        four of five streams are the uncond variant); mem_masks[stream]
        (B or 1, Tk_s) bool, True = pad.  Returns (tgt, att[stream] (B,
        Tq, Tk_s))."""
        mem_masks = mem_masks or {}
        tgt2 = self.norm1(tgt)
        tgt2, _ = self.self_attn(tgt2, tgt2, tgt2, need_weights=False)
        tgt = tgt + tgt2
        tgt = tgt + self.time_block1(tgt, time_embed)

        q_cond = self.norm2(tgt)
        branch_outs, att = [], {}
        for s in COND_STREAMS:
            mod, norm = self._cross(s)
            k, v = mod.project_kv(norm(memory[s]))
            o, w = mod.grouped_attend(mod.q_proj(q_cond)[None], k, v,
                                      mem_masks.get(s))
            branch_outs.append(mod.out_proj(o[0]))
            att[s] = w[0]
        tgt = tgt + self.att_fuser(torch.cat(branch_outs, dim=-1))
        tgt = tgt + self.time_block2(tgt, time_embed)
        tgt = tgt + self.ffn(self.norm3(tgt))
        return tgt, att

    def guided(self, tgt7, mem_real, mem_unc, time_embed,
               masks_real=None, masks_unc=None):
        """tgt7 (G, B, Tq, D) branch-major latents; mem_real[s] (B, Tk, D);
        mem_unc[s] (B or 1, Tk, D); time_embed (B, 1, D).  Returns (tgt7,
        att[s] (B, Tq, Tk)) with att from the full-condition branch."""
        masks_real = masks_real or {}
        masks_unc = masks_unc or {}
        g, b, tq, d = tgt7.shape

        flat = self.norm1(tgt7).reshape(g * b, tq, d)
        sa, _ = self.self_attn(flat, flat, flat, need_weights=False)
        tgt7 = tgt7 + sa.reshape(g, b, tq, d)
        tgt7 = tgt7 + self.time_block1(tgt7, time_embed[None])

        tgt2 = self.norm2(tgt7)
        branch_outs, att = [], {}
        for s in COND_STREAMS:
            mod, norm = self._cross(s)
            r_idx = getattr(self, f"_real_idx_{s}")
            u_idx = getattr(self, f"_unc_idx_{s}")
            k_r, v_r = mod.project_kv(norm(mem_real[s]))
            k_u, v_u = mod.project_kv(norm(mem_unc[s]))
            q_all = mod.q_proj(tgt2)
            o_r, w_r = mod.grouped_attend(q_all.index_select(0, r_idx),
                                          k_r, v_r, masks_real.get(s))
            o_u, _ = mod.grouped_attend(q_all.index_select(0, u_idx),
                                        k_u, v_u, masks_unc.get(s))
            out = torch.empty_like(q_all)
            out.index_copy_(0, r_idx, o_r)
            out.index_copy_(0, u_idx, o_u)
            branch_outs.append(mod.out_proj(out))
            att[s] = w_r[-1]   # last real branch = full condition
        tgt7 = tgt7 + self.att_fuser(torch.cat(branch_outs, dim=-1))
        tgt7 = tgt7 + self.time_block2(tgt7, time_embed[None])
        tgt7 = tgt7 + self.ffn(self.norm3(tgt7))
        return tgt7, att


class DenoiserDecoder(nn.Module):
    """Stack of TransformerDecoderLayer2Att collecting per-layer attention
    maps: att[stream] is (B, L, Tq, Tk)."""

    def __init__(self, d_model: int, num_layers: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer2Att(d_model, nhead, dim_feedforward,
                                        activation, normalize_before, dtype)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model)

    @staticmethod
    def _stack(per_layer):
        return {s: torch.stack([a[s] for a in per_layer], dim=1)
                for s in COND_STREAMS}

    def forward(self, tgt, memory, time_embed, mem_masks=None):
        out, per_layer = tgt, []
        for layer in self.layers:
            out, att = layer(out, memory, time_embed, mem_masks)
            per_layer.append(att)
        return self.norm(out), self._stack(per_layer)

    def guided(self, tgt7, mem_real, mem_unc, time_embed, masks_real=None,
               masks_unc=None):
        out, per_layer = tgt7, []
        for layer in self.layers:
            out, att = layer.guided(out, mem_real, mem_unc, time_embed,
                                    masks_real, masks_unc)
            per_layer.append(att)
        return self.norm(out), self._stack(per_layer)
