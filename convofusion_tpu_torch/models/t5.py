"""T5 encoder + projection head (``convofusion_tpu/models/t5.py:22-196``).

RMS norm, relative position buckets (block 0 only, reused by every later
block), unscaled attention, ReLU feed-forward: the t5-base recipe.  Module
names follow HF ``T5EncoderModel`` (``encoder.block.{i}.layer.0.
SelfAttention.q``, ``layer.1.DenseReluDense.wi``, ...) so
``convofusion_tpu.models.t5.t5_params_from_torch`` reads a port state_dict,
and the projection is the reference's ``Sequential(ReLU, Linear)``.

The trunk is frozen (reference t5.py:35-37): its parameters have
``requires_grad=False`` and it runs under ``torch.no_grad()``, so the
gradient stops at its output as JAX's ``stop_gradient`` does
(``convofusion_tpu/models/t5.py:189-193``).  ``dropout`` (the text
encoder's ``params.dropout``) is applied at JAX's six sites
(``convofusion_tpu/models/t5.py:96-97,123,129,132,151,160``): the attention
weights, the two residual branches, the FFN's inner activation, the
embedding output and the stack's output.  It acts only while the module
trains (the stage-2 loss), with masks from the loss's generator
(``ops/layers.Dropout``); it belongs to the forward alone and changes no
weight.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from convofusion_tpu_torch.ops.layers import Dropout, Embedding, Linear


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction or bias; fp32 math, cast back."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        dtype = x.dtype
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * (var + self.eps) ** -0.5
        return (self.weight * x).to(dtype)


def relative_position_bucket(relative_position, num_buckets=32,
                             max_distance=128):
    """Bidirectional T5 bucket function (HF semantics), numpy, with the
    int32 truncation of the JAX package (t5.py:46-50)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, has_relative_bias=False,
                 num_buckets=32, max_distance=128, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        inner = num_heads * d_kv
        self.dropout = Dropout(dropout)
        self.num_heads, self.d_kv = num_heads, d_kv
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.q = Linear(d_model, inner, bias=False, dtype=dtype)
        self.k = Linear(d_model, inner, bias=False, dtype=dtype)
        self.v = Linear(d_model, inner, bias=False, dtype=dtype)
        self.o = Linear(inner, d_model, bias=False, dtype=dtype)
        if has_relative_bias:
            self.relative_attention_bias = Embedding(
                num_buckets, num_heads, dtype=dtype)
            # (L, L) buckets for the longest text seen so far, grown on
            # demand: a copy from the host at every call would make the
            # host wait for the card
            self.register_buffer("_buckets", torch.zeros(
                (0, 0), dtype=torch.long), persistent=False)

    def compute_bias(self, t: int):
        """(1, H, T, T) relative position bias.  A bucket depends on j - i
        only, so the top-left (T, T) block of a longer table is T's."""
        if self._buckets.shape[0] < t:
            pos = np.arange(t)
            buckets = relative_position_bucket(
                pos[None, :] - pos[:, None], self.num_buckets,
                self.max_distance)
            self._buckets = torch.from_numpy(buckets.astype(np.int64)).to(
                self._buckets.device)
        idx = self._buckets[:t, :t]
        return self.relative_attention_bias(idx).permute(2, 0, 1)[None]

    def forward(self, x, attention_mask=None, position_bias=None):
        b, t, _ = x.shape
        h, dk = self.num_heads, self.d_kv
        q = self.q(x).reshape(b, t, h, dk).transpose(1, 2)
        k = self.k(x).reshape(b, t, h, dk).transpose(1, 2)
        v = self.v(x).reshape(b, t, h, dk).transpose(1, 2)
        scores = q @ k.transpose(-1, -2)          # T5 attention is unscaled
        if hasattr(self, "relative_attention_bias"):
            position_bias = self.compute_bias(t)
        if position_bias is not None:
            scores = scores + position_bias
        if attention_mask is not None:            # True = valid here
            scores = scores.masked_fill(
                ~attention_mask[:, None, None, :], -1e9)
        weights = self.dropout(
            torch.softmax(scores.float(), dim=-1).to(q.dtype))
        out = (weights @ v).transpose(1, 2).reshape(b, t, h * dk)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, has_relative_bias, dropout,
                 dtype):
        super().__init__()
        self.SelfAttention = T5Attention(
            d_model, num_heads, d_kv, has_relative_bias, dropout=dropout,
            dtype=dtype)
        self.layer_norm = T5LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, x, attention_mask, position_bias):
        h, position_bias = self.SelfAttention(
            self.layer_norm(x), attention_mask, position_bias)
        return x + self.dropout(h), position_bias


class T5DenseReluDense(nn.Module):
    def __init__(self, d_model, d_ff, dropout, dtype):
        super().__init__()
        self.wi = Linear(d_model, d_ff, bias=False, dtype=dtype)
        self.wo = Linear(d_ff, d_model, bias=False, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.wo(self.dropout(F.relu(self.wi(x))))


class T5LayerFF(nn.Module):
    def __init__(self, d_model, d_ff, dropout, dtype):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(d_model, d_ff, dropout, dtype)
        self.layer_norm = T5LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return x + self.dropout(self.DenseReluDense(self.layer_norm(x)))


class T5Block(nn.Module):
    def __init__(self, d_model, d_ff, num_heads, d_kv,
                 has_relative_bias=False, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(d_model, num_heads, d_kv,
                                 has_relative_bias, dropout, dtype),
            T5LayerFF(d_model, d_ff, dropout, dtype),
        ])

    def forward(self, x, attention_mask=None, position_bias=None):
        x, position_bias = self.layer[0](x, attention_mask, position_bias)
        return self.layer[1](x), position_bias


class T5EncoderStack(nn.Module):
    def __init__(self, vocab_size=32128, d_model=768, d_ff=3072,
                 num_layers=12, num_heads=12, d_kv=64, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.embed_tokens = Embedding(vocab_size, d_model, dtype=dtype)
        self.block = nn.ModuleList(
            T5Block(d_model, d_ff, num_heads, d_kv,
                    has_relative_bias=(i == 0), dropout=dropout, dtype=dtype)
            for i in range(num_layers))
        self.final_layer_norm = T5LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids, attention_mask=None):
        x = self.dropout(self.embed_tokens(input_ids))
        position_bias = None
        for blk in self.block:
            x, position_bias = blk(x, attention_mask, position_bias)
        return self.dropout(self.final_layer_norm(x))


class T5EncoderModel(nn.Module):
    """HF naming: the stack lives under ``encoder``."""

    def __init__(self, **kw):
        super().__init__()
        self.encoder = T5EncoderStack(**kw)

    def forward(self, input_ids, attention_mask=None):
        return self.encoder(input_ids, attention_mask)


class T5TextEncoder(nn.Module):
    """Frozen T5 trunk + trainable ReLU/Linear projection to the condition
    dim."""

    def __init__(self, latent_dim=512, vocab_size=32128, d_model=768,
                 d_ff=3072, num_layers=12, num_heads=12, d_kv=64,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.dropout = float(dropout)
        self.text_model = T5EncoderModel(
            vocab_size=vocab_size, d_model=d_model, d_ff=d_ff,
            num_layers=num_layers, num_heads=num_heads, d_kv=d_kv,
            dropout=dropout, dtype=dtype)
        self.text_model.requires_grad_(False)
        self.projection = nn.Sequential(
            nn.ReLU(), Linear(d_model, latent_dim, dtype=dtype))

    def forward(self, input_ids, attention_mask=None):
        """input_ids (B, T) int; attention_mask (B, T) bool, True = valid.
        Returns (text_emb (B, T, latent_dim), attention_mask)."""
        with torch.no_grad():
            hidden = self.text_model(input_ids, attention_mask)
        return self.projection(hidden), attention_mask
