"""Dense, LayerNorm and Embed with the JAX package's dtype rules, dropout,
and the seeded weight init.

The JAX modules keep fp32 parameters and take a ``dtype`` (compute dtype):
``nn.Dense(dtype=bf16)`` casts its input and kernel to bf16 and returns bf16;
``nn.Embed(dtype=bf16)`` returns bf16 rows; ``nn.LayerNorm()`` with no dtype
promotes a bf16 input against its fp32 scale and returns fp32
(``convofusion_tpu/ops/transformer.py:291-302``).  Here a ``Linear`` or an
``nn.Embedding`` stores its weight in the compute dtype (rounding once what
flax rounds at every use) and a ``LayerNorm`` keeps fp32 weights and
computes and returns fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Dense(dtype=...)``: the input is cast to the weight's dtype."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Dropout(nn.Module):
    """``nn.Dropout(rate)(x, deterministic=not training)``: the identity,
    with no op launched, unless the module trains and ``p > 0``.  Masks
    come from PyTorch's default generator of the input's device."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if self.training and self.p > 0.0:
            return F.dropout(x, self.p, True)
        return x

    def extra_repr(self) -> str:
        return f"p={self.p}"


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(epsilon=1e-5)``: fp32 weights, fp32 math and output."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__(d, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init at the scale of the flax defaults: Dense kernels lecun
    normal (std 1/sqrt(fan_in)), zero biases, Embed rows std
    1/sqrt(features), norms at one (T5LayerNorm starts at one and is left
    alone), the VAE's global motion tokens std 1 (flax ``normal(1.0)``,
    convofusion_tpu/models/vae.py:91-96).  Values are drawn in fp32 on the CPU
    and cast into each parameter, so one seed gives the same weights on
    every device and (up to rounding) in every dtype."""

    def fill(p, std):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, nn.Linear):
            fill(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            fill(m.weight, 1.0 / math.sqrt(m.embedding_dim))
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        for name, p in m.named_parameters(recurse=False):
            if name == "in_proj_weight":      # packed q/k/v (d_model, d_model)
                fill(p, 1.0 / math.sqrt(p.shape[1]))
            elif name == "in_proj_bias":
                nn.init.zeros_(p)
            elif name.endswith("_global_motion_token"):
                fill(p, 1.0)
