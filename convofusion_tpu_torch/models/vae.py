"""Chunked body/hands motion VAE, decoder half.

Port of ``ConvoFusionVae.decode`` for the production ``encoder_decoder``
arch (``convofusion_tpu/models/vae.py:184-218``): 128 zero queries plus the
sine PE cross-attend, through one skip decoder per part, to the 8 chunk
latents plus the sine PE.  The encoder (stage-1 training) is still to be
ported; ``compat/from_jax.py`` skips its parameters by name.
"""
from __future__ import annotations

import torch
from torch import nn

from convofusion_tpu_torch.ops.layers import Linear
from convofusion_tpu_torch.ops.positional import PositionEmbeddingSine1D
from convofusion_tpu_torch.ops.transformer import SkipTransformerDecoder

BODY_NFEATS = 23 * 3
HANDS_NFEATS = 40 * 3


class ConvoFusionVae(nn.Module):
    def __init__(self, latent_dim: int = 128, ff_size: int = 1024,
                 num_layers: int = 5, num_heads: int = 2,
                 arch: str = "encoder_decoder", normalize_before: bool = True,
                 activation: str = "gelu", position_embedding: str = "sine",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if arch != "encoder_decoder":
            raise NotImplementedError(f"VAE arch {arch!r} is not ported")
        if position_embedding != "sine":
            raise NotImplementedError(
                f"position embedding {position_embedding!r} is not ported")
        d = latent_dim
        self.query_pos_decoder = PositionEmbeddingSine1D(d)
        self.mem_pos_decoder = PositionEmbeddingSine1D(d)
        kw = dict(d_model=d, num_layers=num_layers, nhead=num_heads,
                  dim_feedforward=ff_size, activation=activation,
                  normalize_before=normalize_before, dtype=dtype)
        self.body_decoder = SkipTransformerDecoder(**kw)
        self.hands_decoder = SkipTransformerDecoder(**kw)
        self.body_final_layer = Linear(d, BODY_NFEATS, dtype=dtype)
        self.hands_final_layer = Linear(d, HANDS_NFEATS, dtype=dtype)

    def decode(self, z: torch.Tensor, nframes: int = 128) -> torch.Tensor:
        """z (2, B, n_chunks, D) -> motion (B, nframes, nfeats).  The whole
        clip's queries attend to all 8 chunk latents jointly."""
        _, b, _, d = z.shape
        queries = self.query_pos_decoder(
            torch.zeros(b, nframes, d, dtype=z.dtype, device=z.device))
        out_b = self.body_decoder(queries, self.mem_pos_decoder(z[0]))
        out_h = self.hands_decoder(queries, self.mem_pos_decoder(z[1]))
        return torch.cat([self.body_final_layer(out_b),
                          self.hands_final_layer(out_h)], dim=-1)
