"""Multi-head attention that also returns head-averaged attention weights.

Port of ``convofusion_tpu/ops/attention.py:29-130``.  Parameters follow
torch ``nn.MultiheadAttention`` (packed ``in_proj_weight`` /
``in_proj_bias`` + ``out_proj``), the reference's own names, so
``convofusion_tpu/compat/torch_loader.mha`` reads a port state_dict.

The softmax is written out: logits at padded keys are set to -1e9 (not
-inf) and the softmax runs in fp32, so a fully padded row gives uniform
weights instead of NaN, and the weights exist for the callers that keep
them (scaled_dot_product_attention returns none).  Attention dropout
(``dropout``, the JAX module's rate) drops the softmax weights before they
meet the values; the weights returned are the ones before dropout
(``convofusion_tpu/ops/attention.py:88-98``).

Placed by ``parallel/tp.apply_tp`` (``tp`` set), the module holds model
rank r's thirds ``[q_r; k_r; v_r]`` of the packed projection and a
row-parallel ``out_proj``: with heads that divide by the model ranks it
attends over its own heads, else (the single-head streams) over the
all-gathered q/k/v, passing on its slice of the output.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from convofusion_tpu_torch.ops.layers import (
    Dropout,
    Linear,
    default_init_enabled,
)

_BIG_NEG = -1e9


@functools.lru_cache(maxsize=None)
def _sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) rounded to ``dtype``, as jnp.sqrt(jnp.asarray(n, dtype))."""
    return float(torch.tensor(math.sqrt(n), dtype=dtype))


def _softmax(logits, dtype):
    return torch.softmax(logits.float(), dim=-1).to(dtype)


class MultiheadAttention(nn.Module):
    tp = None       # the model axis, once parallel/tp.apply_tp placed it

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.head_dim = d_model // num_heads
        if self.head_dim * num_heads != d_model:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model, dtype=dtype))
        self.in_proj_bias = nn.Parameter(
            torch.zeros(3 * d_model, dtype=dtype))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        self.attn_dropout = Dropout(dropout)
        if default_init_enabled():
            nn.init.xavier_uniform_(self.in_proj_weight)

    @property
    def dtype(self):
        return self.in_proj_weight.dtype

    def _proj(self, x, lo, hi):
        d = self.in_proj_weight.shape[0] // 3     # this rank's share of q
        x = x.to(self.dtype)
        if self.tp is not None:
            x = self.tp.copy_to(x)
        return F.linear(x, self.in_proj_weight[lo * d:hi * d],
                        self.in_proj_bias[lo * d:hi * d])

    def q_proj(self, x):
        return self._proj(x, 0, 1)

    def project_kv(self, memory):
        """(B, Tk, D) -> (k, v): one GEMM for both projections."""
        return self._proj(memory, 1, 3).chunk(2, dim=-1)

    def forward(self, query, key, value,
                key_padding_mask: Optional[torch.Tensor] = None,
                need_weights: bool = True):
        """query (B, Tq, D); key/value (B, Tk, D); key_padding_mask (B, Tk)
        bool, True = PAD.  Returns (out, weights (B, Tq, Tk) averaged over
        heads, or None)."""
        h, hd = self.num_heads, self.head_dim
        if query is key and key is value:
            q, k, v = self._proj(query, 0, 3).chunk(3, dim=-1)
        elif key is value:
            q = self.q_proj(query)
            k, v = self.project_kv(key)
        else:
            q, k, v = (self._proj(query, 0, 1), self._proj(key, 1, 2),
                       self._proj(value, 2, 3))
        tp = self.tp
        own_heads = tp is not None and h % tp.size == 0
        if own_heads:
            h //= tp.size
        elif tp is not None:
            q, k, v = (tp.gather_from(t) for t in (q, k, v))
        b, tq, _ = q.shape
        tk = k.shape[1]
        q = q.reshape(b, tq, h, hd).transpose(1, 2)
        k = k.reshape(b, tk, h, hd).transpose(1, 2)
        v = v.reshape(b, tk, h, hd).transpose(1, 2)

        logits = (q @ k.transpose(-1, -2)) / _sqrt_in(hd, q.dtype)
        if key_padding_mask is not None:
            logits = logits.masked_fill(
                key_padding_mask[:, None, None, :], _BIG_NEG)
        weights = _softmax(logits, self.dtype)
        out = (self.attn_dropout(weights) @ v).transpose(1, 2).reshape(
            b, tq, h * hd)
        if tp is not None and not own_heads:
            out = tp.scatter_to(out)
        out = self.out_proj(out)
        if not need_weights:
            return out, None
        if own_heads:        # the mean over every rank's heads
            return out, tp.reduce_from(weights.sum(dim=1)) / self.num_heads
        return out, weights.mean(dim=1)

    def grouped_attend(self, q_group, k, v, key_padding_mask=None):
        """Single-head attention of G guidance branches sharing keys.

        q_group (G, B, Tq, D); k/v (B, Tk, D), or single shared rows
        (1, Tk, D) that broadcast against the batch (the uncond variant);
        key_padding_mask (B, Tk) or (1, Tk), True = pad.  Returns
        (out (G, B, Tq, D), weights (G, B, Tq, Tk))."""
        if self.num_heads != 1:
            raise ValueError("grouped_attend is single-head")
        if self.tp is not None:     # this rank's features: attend on all
            q_group, k, v = (self.tp.gather_from(t) for t in (q_group, k, v))
        scale = _sqrt_in(self.d_model, q_group.dtype)
        shared_kv = k.shape[0] == 1 and q_group.shape[1] != 1
        if shared_kv:
            k, v = k[0], v[0]
        logits = (q_group @ k.transpose(-1, -2)) / scale
        if key_padding_mask is not None:
            logits = logits.masked_fill(
                key_padding_mask[None, :, None, :], _BIG_NEG)
        weights = _softmax(logits, self.dtype)
        out = self.attn_dropout(weights) @ v
        if self.tp is not None:
            out = self.tp.scatter_to(out)
        return out, weights
