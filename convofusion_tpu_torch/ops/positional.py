"""Positional encodings, batch-first (B, T, D).

Port of ``convofusion_tpu/ops/positional.py:14-86``: the sine table, the
1D sine PE, the body/hands interleaved ``sine_bh`` PE, the learned PE and
``build_position_encoding``.  A sine table is a non-persistent buffer, so
it moves with the module and is cast to the input's dtype at use, as the
JAX code casts it; the learned table is an fp32 parameter cast the same
way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic transformer sine/cos table, shape (max_len, d_model)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionEmbeddingSine1D(nn.Module):
    """x + sine PE along the sequence axis."""

    def __init__(self, d_model: int, max_len: int = 1024):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(max_len, d_model)),
            persistent=False)

    def forward(self, x):
        return x + self.pe[None, : x.shape[1]].to(x.dtype)


class PositionEmbeddingSineBH(PositionEmbeddingSine1D):
    """Tokens 2i (body) and 2i+1 (hands) both get the PE of position i."""

    def forward(self, x):
        t = x.shape[1]
        pe = torch.repeat_interleave(self.pe[: (t + 1) // 2], 2, dim=0)[:t]
        return x + pe[None].to(x.dtype)


class PositionEmbeddingLearned1D(nn.Module):
    """x + a learned (max_len, d_model) table, drawn U(0, 1) (JAX :60-72;
    ``ops/layers.init_weights`` redraws it from the model's generator)."""

    def __init__(self, d_model: int, max_len: int = 1024):
        super().__init__()
        self.pe = nn.Parameter(torch.rand(max_len, d_model))

    def forward(self, x):
        return x + self.pe[None, : x.shape[1]].to(x.dtype)


def build_position_encoding(d_model: int, position_embedding: str = "sine",
                            max_len: int = 1024) -> nn.Module:
    """The PE of a config's ``position_embedding`` (JAX :75-84)."""
    if position_embedding in ("v2", "sine"):
        return PositionEmbeddingSine1D(d_model, max_len)
    if position_embedding == "sine_bh":
        return PositionEmbeddingSineBH(d_model, max_len)
    if position_embedding in ("v3", "learned"):
        return PositionEmbeddingLearned1D(d_model, max_len)
    raise ValueError(f"position_embedding {position_embedding!r} is not "
                     f"supported (sine/v2, sine_bh, learned/v3)")
