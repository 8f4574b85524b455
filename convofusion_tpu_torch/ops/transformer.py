"""Transformer blocks: the skip encoder and skip decoder of the VAE and the
five-stream conditional decoder layer of the denoiser.

Port of ``convofusion_tpu/ops/transformer.py``: ``_FFN``,
``TransformerEncoderLayer``, ``TransformerDecoderLayer``,
``SkipTransformerEncoder``, ``SkipTransformerDecoder``, ``TimeBlock``
(:38-252), ``TransformerDecoderLayer2Att.__call__`` / ``.forward_mem`` /
``.guided`` (:255-510), ``DenoiserDecoder.__call__`` / ``.forward_mem`` /
``.guided`` (:513-627), the fused-stream layer and stack
``FusedTransformerDecoderLayer2Att`` / ``FusedDenoiserDecoder``
(:630-729, the cross-attentions in ``ops/fused_streams.py``) and the
guidance tables (:26,732-750).  The VAE's encoder and decoder layers are
pre-norm or post-norm (JAX :60-145); the denoiser's layers are pre-norm
and raise otherwise, as JAX asserts (:282, :651).  With ``remat`` a decoder
stack recomputes each layer's activations in the backward pass of a
training forward (the module in train mode with grad enabled; JAX
``nn.remat`` over the layer, :523-546, :700-711): sampling, WEG's gradient
pass included, runs the same kernels with and without it.  ``forward``
here is both ``__call__`` and ``forward_mem``: its cross-attention
broadcasts single-row memories, so one body serves full and mixed-batch
streams.  Dropout sits where JAX has it: the attention
weights, the FFN after its activation, each residual branch, and the
TimeBlock after its SiLU; each is the identity unless the module trains.
The encoder and decoder layers take JAX's ``pos`` / ``query_pos``, added
to queries and keys; no model passes them (the PEs are added to the
inputs), so they are None on every path.

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
from convofusion_tpu_torch.ops import layer_norm
from convofusion_tpu_torch.ops.cross_attend import grouped_cross_attend
from convofusion_tpu_torch.ops.layers import (
    Dropout,
    LayerNorm,
    Linear,
    checkpointed,
)

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
    """linear1 -> activation -> dropout -> linear2.  A mixin: the reference
    keeps ``linear1``/``linear2`` directly on the layer, not under
    ``ffn``."""

    def _init_ffn(self, d_model, dim_feedforward, activation, dtype,
                  dropout):
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.act = _activation(activation)
        self.ffn_dropout = Dropout(dropout)

    def ffn(self, x):
        return self.linear2(self.ffn_dropout(self.act(self.linear1(x))))


def _with_pos(x, pos):
    return x if pos is None else x + pos


class TransformerEncoderLayer(_FFN):
    """Encoder layer, pre-norm (the production VAE, modules/motion_vae.yaml)
    or post-norm (LayerNorm after each residual add, JAX :60-93).  ``pos``
    is added to the queries and keys, not the values."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.normalize_before = bool(normalize_before)
        self.self_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self._init_ffn(d_model, dim_feedforward, activation, dtype, dropout)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, src, pos=None):
        if self.normalize_before:
            src2 = self.norm1(src)
            qk = _with_pos(src2, pos)
            src2, _ = self.self_attn(qk, qk, src2, need_weights=False)
            src = src + self.drop(src2)
            return src + self.drop(self.ffn(self.norm2(src)))
        qk = _with_pos(src, pos)
        src2, _ = self.self_attn(qk, qk, src, need_weights=False)
        src = self.norm1(src + self.drop(src2))
        return self.norm2(src + self.drop(self.ffn(src)))


class TransformerDecoderLayer(_FFN):
    """Decoder layer, pre-norm (the production VAE decoder) or post-norm
    (JAX :96-145).  ``query_pos`` is added to the queries and the
    self-attention keys, ``pos`` to the memory's keys."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.normalize_before = bool(normalize_before)
        self.self_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dtype,
                                                 dropout)
        self._init_ffn(d_model, dim_feedforward, activation, dtype, dropout)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, tgt, memory, pos=None, query_pos=None):
        mem_k = _with_pos(memory, pos)
        if self.normalize_before:
            tgt2 = self.norm1(tgt)
            qk = _with_pos(tgt2, query_pos)
            tgt2, _ = self.self_attn(qk, qk, tgt2, need_weights=False)
            tgt = tgt + self.drop(tgt2)
            tgt2, _ = self.multihead_attn(
                _with_pos(self.norm2(tgt), query_pos), mem_k, memory,
                need_weights=False)
            tgt = tgt + self.drop(tgt2)
            return tgt + self.drop(self.ffn(self.norm3(tgt)))
        qk = _with_pos(tgt, query_pos)
        tgt2, _ = self.self_attn(qk, qk, tgt, need_weights=False)
        tgt = self.norm1(tgt + self.drop(tgt2))
        tgt2, _ = self.multihead_attn(_with_pos(tgt, query_pos), mem_k,
                                      memory, need_weights=False)
        tgt = self.norm2(tgt + self.drop(tgt2))
        return self.norm3(tgt + self.drop(self.ffn(tgt)))


class _SkipStack(nn.Module):
    """U-Net-style layer stack: (n-1)/2 in-blocks, middle, (n-1)/2
    out-blocks with Linear(2d->d) skip merges, then a LayerNorm."""

    layer_cls = None

    def __init__(self, d_model: int, num_layers: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if num_layers % 2 != 1:
            raise ValueError(f"{type(self).__name__} needs an odd depth")
        num_block = (num_layers - 1) // 2

        def layer():
            return self.layer_cls(d_model, nhead, dim_feedforward,
                                  activation, normalize_before, dtype,
                                  dropout)

        self.input_blocks = nn.ModuleList(layer() for _ in range(num_block))
        self.middle_block = layer()
        self.output_blocks = nn.ModuleList(layer() for _ in range(num_block))
        self.linear_blocks = nn.ModuleList(
            Linear(2 * d_model, d_model, dtype=dtype)
            for _ in range(num_block))
        self.norm = LayerNorm(d_model)

    def forward(self, x, *memory, **pos):
        """``memory``: the decoder's cross-attention memory, none for the
        encoder; ``pos`` (``pos=``, and ``query_pos=`` for the decoder)
        goes to every layer.  No padding masks: the VAE's 128 frames, 8
        chunks and 16-frame chunks are static."""
        xs = []
        for blk in self.input_blocks:
            x = blk(x, *memory, **pos)
            xs.append(x)
        x = self.middle_block(x, *memory, **pos)
        for lin, blk in zip(self.linear_blocks, self.output_blocks):
            x = lin(torch.cat([x, xs.pop()], dim=-1))
            x = blk(x, *memory, **pos)
        return self.norm(x)


class SkipTransformerEncoder(_SkipStack):
    layer_cls = TransformerEncoderLayer


class SkipTransformerDecoder(_SkipStack):
    layer_cls = TransformerDecoderLayer


class TimeBlock(nn.Module):
    """AdaLN-style timestep modulation; returns the residual delta.

    h (..., T, D); emb (..., 1, D)."""

    def __init__(self, latent_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(latent_dim, 2 * latent_dim, dtype=dtype))
        self.norm = LayerNorm(latent_dim)
        self.out_layers = nn.Sequential(
            nn.SiLU(), Dropout(dropout),
            Linear(latent_dim, latent_dim, dtype=dtype))

    def forward(self, h, emb):
        scale, shift = self.emb_layers(emb).chunk(2, dim=-1)
        h = self.norm(h) * (1 + scale) + shift
        return self.out_layers(h)

    def guided(self, h, emb):
        """``forward`` with the norm, the modulation and the SiLU as one
        ``ops/layer_norm.normalize`` (one CUDA kernel on a card)."""
        scale, shift = self.emb_layers(emb).chunk(2, dim=-1)
        _, drop, linear = self.out_layers
        return linear(drop(layer_norm.normalize(self.norm, h, linear, scale,
                                                shift, drop)))


class TransformerDecoderLayer2Att(_FFN):
    """Denoiser layer (pre-norm): self-attn, TimeBlock, five parallel
    single-head cross-attentions over the condition streams, linear fuser,
    second TimeBlock, FFN.

    ``guided`` runs the seven classifier-free-guidance branches at once:
    each stream's K/V is one GEMM over the real and the uncond memory rows
    that ``DenoiserDecoder.guided`` normalized for every layer at once,
    instead of once per branch, each stream's attention core is
    ``ops/cross_attend.grouped_cross_attend`` (one CUDA kernel a stream on
    a card), and each other LayerNorm comes out of
    ``ops/layer_norm.normalize`` in the dtype of the Linear that reads it
    (one CUDA kernel a norm on a card); the residual stream stays fp32."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if not normalize_before:
            raise ValueError("the denoiser layer is pre-norm "
                             "(modules/denoiser.yaml)")
        d = d_model
        self.self_attn = MultiheadAttention(d, nhead, dtype, dropout)
        self.time_block1 = TimeBlock(d, dtype, dropout)
        self.time_block2 = TimeBlock(d, dtype, dropout)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)
        for s in COND_STREAMS:
            setattr(self, f"multihead_attn_{s}",
                    MultiheadAttention(d, 1, dtype, dropout))
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
        self._init_ffn(d, dim_feedforward, activation, dtype, dropout)
        self.drop = Dropout(dropout)

    def _cross(self, s):
        return (getattr(self, f"multihead_attn_{s}"),
                getattr(self, f"{s}_norm"))

    def _kv(self, s, mem):
        """Stream ``s``'s memory LayerNorm + K/V projection."""
        mod, norm = self._cross(s)
        return mod.project_kv(norm(mem))

    def forward(self, tgt, memory: Dict[str, torch.Tensor], time_embed,
                mem_masks: Optional[Dict[str, torch.Tensor]] = None):
        """tgt (B, Tq, D); memory[stream] (B, Tk_s, D), or single shared
        rows (1, Tk_s, D) that stay at batch 1 through LayerNorm + K/V and
        broadcast inside ``grouped_attend`` (the WEG text-only pass, where
        four of five streams are the uncond variant); mem_masks[stream]
        (B or 1, Tk_s) bool, True = pad.  Returns (tgt, att[stream] (B,
        Tq, Tk_s))."""
        kv = {s: self._kv(s, memory[s]) for s in COND_STREAMS}
        mem_masks = mem_masks or {}
        tgt2 = self.norm1(tgt)
        tgt2, _ = self.self_attn(tgt2, tgt2, tgt2, need_weights=False)
        tgt = tgt + self.drop(tgt2)
        tgt = tgt + self.time_block1(tgt, time_embed)

        q_cond = self.norm2(tgt)
        branch_outs, att = [], {}
        for s in COND_STREAMS:
            mod, _ = self._cross(s)
            k, v = kv[s]
            o, w = mod.grouped_attend(mod.q_proj(q_cond)[None], k, v,
                                      mem_masks.get(s))
            branch_outs.append(mod.out_proj(o[0]))
            att[s] = w[0]
        tgt = tgt + self.drop(self.att_fuser(torch.cat(branch_outs, dim=-1)))
        tgt = tgt + self.time_block2(tgt, time_embed)
        tgt = tgt + self.drop(self.ffn(self.norm3(tgt)))
        return tgt, att

    def guided(self, tgt7, memory, time_embed, masks_real=None,
               masks_unc=None):
        """tgt7 (G, B, Tq, D) branch-major latents; memory[s] = (rows,
        real, unc): stream ``s``'s memory rows through this layer's
        ``{s}_norm`` (``DenoiserDecoder.guided``), the real rows then the
        uncond ones, and the real (B, Tk) and uncond (B or 1, Tk) shapes;
        time_embed (B, 1, D).  Returns (tgt7, att[s] (B, Tq, Tk)) with att
        from the full-condition branch."""
        masks_real = masks_real or {}
        masks_unc = masks_unc or {}
        # per stream one K/V GEMM for both guidance variants; their keys
        # and values are row views of its output
        kv = {}
        for s in COND_STREAMS:
            rows, real, unc = memory[s]
            k, v = self._cross(s)[0].project_kv(rows)
            n = real[0] * real[1]
            kv[s] = ((k[:n].view(*real, -1), v[:n].view(*real, -1)),
                     (k[n:].view(*unc, -1), v[n:].view(*unc, -1)))
        g, b, tq, d = tgt7.shape

        flat = layer_norm.normalize(self.norm1, tgt7, self.self_attn).reshape(
            g * b, tq, d)
        sa, _ = self.self_attn(flat, flat, flat, need_weights=False)
        tgt7 = tgt7 + self.drop(sa.reshape(g, b, tq, d))
        tgt7 = tgt7 + self.time_block1.guided(tgt7, time_embed[None])

        # one norm for the five streams' query projections
        tgt2 = layer_norm.normalize(self.norm2, tgt7,
                                    self._cross(COND_STREAMS[0])[0])
        branch_outs, att = [], {}
        for s in COND_STREAMS:
            mod, _ = self._cross(s)
            # each branch's rows over the real or the uncond K/V: one CUDA
            # kernel on a card, else the plain gather, attend and scatter
            out, att[s] = grouped_cross_attend(
                mod, mod.q_proj(tgt2), *kv[s], masks_real.get(s),
                masks_unc.get(s), REAL_BRANCHES[s],
                getattr(self, f"_real_idx_{s}"),
                getattr(self, f"_unc_idx_{s}"))
            branch_outs.append(mod.out_proj(out))
        tgt7 = tgt7 + self.drop(self.att_fuser(torch.cat(branch_outs,
                                                         dim=-1)))
        tgt7 = tgt7 + self.time_block2.guided(tgt7, time_embed[None])
        tgt7 = tgt7 + self.drop(self.ffn(layer_norm.normalize(
            self.norm3, tgt7, self.linear1)))
        return tgt7, att


class _Stack(nn.Module):
    """A decoder stack's layers, final norm and the ``remat`` switch."""

    layer_cls = None

    def __init__(self, d_model: int, num_layers: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            self.layer_cls(d_model, nhead, dim_feedforward, activation,
                           normalize_before, dtype, dropout)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.remat = bool(remat)

    def _layer(self, layer, *args):
        """One layer's training forward, recomputed in the backward pass
        when ``remat`` is on."""
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpointed(layer, *args)
        return layer(*args)


class DenoiserDecoder(_Stack):
    """Stack of TransformerDecoderLayer2Att collecting per-layer attention
    maps: att[stream] is (B, L, Tq, Tk)."""

    layer_cls = TransformerDecoderLayer2Att

    @staticmethod
    def _stack(per_layer):
        return {s: torch.stack([a[s] for a in per_layer], dim=1)
                for s in COND_STREAMS}

    def forward(self, tgt, memory, time_embed, mem_masks=None):
        out, per_layer = tgt, []
        for layer in self.layers:
            out, att = self._layer(layer, out, memory, time_embed, mem_masks)
            per_layer.append(att)
        return self.norm(out), self._stack(per_layer)

    def guided(self, tgt7, mem_real, mem_unc, time_embed, masks_real=None,
               masks_unc=None):
        """The layers' ``guided``, without the final norm: ``Denoiser.guided``
        applies it in the dtype of the Linear that reads it.  The memory
        is the same for every layer: each layer's memory norms come out of
        one ``ops/layer_norm.normalize_memory`` (one CUDA launch on a
        card), each stream's real rows, then its uncond rows."""
        mems = [(mem_real[s], mem_unc[s]) for s in COND_STREAMS]
        normed = layer_norm.normalize_memory(mems, [
            [(norm, mod) for mod, norm in map(layer._cross, COND_STREAMS)]
            for layer in self.layers])
        shapes = [(r.shape[:-1], u.shape[:-1]) for r, u in mems]
        sizes = [r[0] * r[1] + u[0] * u[1] for r, u in shapes]
        out, per_layer = tgt7, []
        for layer, rows in zip(self.layers, normed):
            memory = {s: (block, *shape) for s, block, shape in
                      zip(COND_STREAMS, rows.split(sizes), shapes)}
            out, att = layer.guided(out, memory, time_embed, masks_real,
                                    masks_unc)
            per_layer.append(att)
        return out, self._stack(per_layer)


class FusedTransformerDecoderLayer2Att(_FFN):
    """:class:`TransformerDecoderLayer2Att` with the five cross-attentions
    batched into one padded attention (``ops/fused_streams.py``), the same
    math; the cross section's weights live under ``cross_streams``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        from convofusion_tpu_torch.ops.fused_streams import FusedCrossStreams

        super().__init__()
        if not normalize_before:
            raise ValueError("the denoiser layer is pre-norm "
                             "(modules/denoiser.yaml)")
        d = d_model
        self.self_attn = MultiheadAttention(d, nhead, dtype, dropout)
        self.time_block1 = TimeBlock(d, dtype, dropout)
        self.time_block2 = TimeBlock(d, dtype, dropout)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)
        self.cross_streams = FusedCrossStreams(d, dtype, dropout)
        self.att_fuser = Linear(len(COND_STREAMS) * d, d, dtype=dtype)
        self._init_ffn(d, dim_feedforward, activation, dtype, dropout)
        self.drop = Dropout(dropout)

    def forward(self, tgt, mem_stack, pad_stack, time_embed):
        """tgt (B, Tq, D); mem_stack (S, B, Tk, D) and pad_stack (S, B, Tk)
        from ``pad_stream_stack``.  Returns (tgt, weights (S, B, Tq,
        Tk))."""
        tgt2 = self.norm1(tgt)
        tgt2, _ = self.self_attn(tgt2, tgt2, tgt2, need_weights=False)
        tgt = tgt + self.drop(tgt2)
        tgt = tgt + self.time_block1(tgt, time_embed)
        cat, weights = self.cross_streams(self.norm2(tgt), mem_stack,
                                          pad_stack)
        tgt = tgt + self.drop(self.att_fuser(cat))
        tgt = tgt + self.time_block2(tgt, time_embed)
        tgt = tgt + self.drop(self.ffn(self.norm3(tgt)))
        return tgt, weights


class FusedDenoiserDecoder(_Stack):
    """:class:`DenoiserDecoder` over fused layers: the memories are padded
    and stacked once a call; the same per-stream attention maps, each
    trimmed to its stream's length."""

    layer_cls = FusedTransformerDecoderLayer2Att

    def forward(self, tgt, memory, time_embed, mem_masks=None):
        from convofusion_tpu_torch.ops.fused_streams import pad_stream_stack

        mem_stack, pad_stack, lengths = pad_stream_stack(memory, mem_masks)
        out, per_layer = tgt, []
        for layer in self.layers:
            out, w = self._layer(layer, out, mem_stack, pad_stack,
                                 time_embed)
            per_layer.append(w)
        stacked = torch.stack(per_layer, dim=2)     # (S, B, L, Tq, Tmax)
        att = {s: stacked[i, ..., :lengths[s]]
               for i, s in enumerate(COND_STREAMS)}
        return self.norm(out), att
