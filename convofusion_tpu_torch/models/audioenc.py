"""Mel-frame encoder (``convofusion_tpu/models/audioenc.py:20-36``): an MLP
Linear 80->256 -> Dropout -> LeakyReLU(0.1) -> Linear 256->512 -> Dropout
-> LeakyReLU(0.1) -> Linear out.  Names follow the reference ``main``
Sequential; the dropout rate is the JAX module's default, 0.1, which
``models/factory.py:164-175`` never overrides."""
from __future__ import annotations

import torch
from torch import nn

from convofusion_tpu_torch.ops.layers import Dropout, Linear


class AudioConvEncoder(nn.Module):
    def __init__(self, input_size: int = 80, hidden_size: int = 256,
                 latent_dim: int = 512, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.main = nn.Sequential(
            Linear(input_size, hidden_size, dtype=dtype), Dropout(dropout),
            nn.LeakyReLU(0.1),
            Linear(hidden_size, latent_dim, dtype=dtype), Dropout(dropout),
            nn.LeakyReLU(0.1))
        self.out_net = Linear(latent_dim, latent_dim, dtype=dtype)

    def forward(self, x):
        """x (B, T_mel, n_mels) -> (B, T_mel, latent_dim)."""
        return self.out_net(self.main(x))
