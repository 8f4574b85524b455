"""Chunked body/hands motion VAE.

Port of ``ConvoFusionVae`` for the production ``encoder_decoder`` arch
(``convofusion_tpu/models/vae.py:35-218``), ``mlp_dist=False``.

- ``encode``: each 128-frame clip is cut into 8 chunks of 16 frames; each
  chunk's root x/z is taken back to its first frame; two learnable tokens
  (mu, logvar) are put before the 16 embedded frames of each part, plus the
  sine PE, through one skip encoder per part; the tokens' outputs are
  (mu, logvar).  The sample is ``mu + exp(0.5 logvar) * eps``.
- ``decode``: 128 zero queries plus the sine PE cross-attend, through one
  skip decoder per part, to the 8 chunk latents plus the sine PE.  The whole
  clip's queries attend to all 8 chunk latents jointly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from convofusion_tpu_torch.ops.layers import Linear
from convofusion_tpu_torch.ops.positional import PositionEmbeddingSine1D
from convofusion_tpu_torch.ops.transformer import (
    SkipTransformerDecoder,
    SkipTransformerEncoder,
)

BODY_NFEATS = 23 * 3
HANDS_NFEATS = 40 * 3
CHUNK_LEN = 16
PARTS = ("body", "hands")


class ConvoFusionVae(nn.Module):
    def __init__(self, latent_dim: int = 128, ff_size: int = 1024,
                 num_layers: int = 5, num_heads: int = 2,
                 arch: str = "encoder_decoder", normalize_before: bool = True,
                 activation: str = "gelu", position_embedding: str = "sine",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 latent_size: int = 1, mlp_dist: bool = False):
        super().__init__()
        if arch != "encoder_decoder":
            raise NotImplementedError(f"VAE arch {arch!r} is not ported")
        if position_embedding != "sine":
            raise NotImplementedError(
                f"position embedding {position_embedding!r} is not ported")
        if mlp_dist:
            raise NotImplementedError("the MLP_DIST distribution head is "
                                      "not ported")
        d = latent_dim
        self.latent_size = latent_size
        self.query_pos_encoder = PositionEmbeddingSine1D(d)
        self.query_pos_decoder = PositionEmbeddingSine1D(d)
        self.mem_pos_decoder = PositionEmbeddingSine1D(d)
        kw = dict(d_model=d, num_layers=num_layers, nhead=num_heads,
                  dim_feedforward=ff_size, activation=activation,
                  normalize_before=normalize_before, dtype=dtype,
                  dropout=dropout)
        self.body_encoder = SkipTransformerEncoder(**kw)
        self.hands_encoder = SkipTransformerEncoder(**kw)
        self.body_decoder = SkipTransformerDecoder(**kw)
        self.hands_decoder = SkipTransformerDecoder(**kw)
        # (mu, logvar) query tokens: fp32 parameters used without a cast,
        # as the JAX module's (vae.py:91-96), drawn N(0, 1)
        for part in PARTS:
            setattr(self, f"{part}_global_motion_token", nn.Parameter(
                torch.randn(2 * latent_size, d)))
        # keeps root x and z of a chunk's first frame (a buffer: a tensor
        # built from a list at each call would copy to the card and wait)
        self.register_buffer("_root_xz", torch.tensor([1.0, 0.0, 1.0]),
                             persistent=False)
        self.body_skel_embedding = Linear(BODY_NFEATS, d, dtype=dtype)
        self.hands_skel_embedding = Linear(HANDS_NFEATS, d, dtype=dtype)
        self.body_final_layer = Linear(d, BODY_NFEATS, dtype=dtype)
        self.hands_final_layer = Linear(d, HANDS_NFEATS, dtype=dtype)

    def encode(self, features: torch.Tensor,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                          torch.Tensor]:
        """features (B, nframes, nfeats) -> (latent (2, B, n_chunks, D),
        (mu, logvar), the chunk-normalised features (B, nframes, nfeats)).

        ``eps`` (the shape of mu) or ``generator`` draws the
        reparameterised sample; with neither, the latent is mu."""
        b, nframes, _ = features.shape
        n_chunks = nframes // CHUNK_LEN
        x = features.reshape(b * n_chunks, CHUNK_LEN, -1)
        # each chunk's root x/z relative to its first frame (vae.py:128-131)
        root_xz = x[:, :1, :3] * self._root_xz.to(x.dtype)
        x = torch.cat([x[:, :, :3] - root_xz, x[:, :, 3:]], dim=-1)

        toks = []
        for part, feats in (("body", x[:, :, :BODY_NFEATS]),
                            ("hands", x[:, :, BODY_NFEATS:])):
            dist = getattr(self, f"{part}_global_motion_token")
            emb = getattr(self, f"{part}_skel_embedding")(feats)
            seq = torch.cat([dist.expand(b * n_chunks, -1, -1),
                             emb.to(dist.dtype)], dim=1)
            out = getattr(self, f"{part}_encoder")(
                self.query_pos_encoder(seq))
            toks.append(out[:, :2 * self.latent_size])
        tok = torch.stack(toks, dim=0)            # (2, B*n, 2*ls, D)
        ls = self.latent_size
        mu = tok[:, :, :ls].reshape(2, b, n_chunks, -1)
        logvar = tok[:, :, ls:].reshape(2, b, n_chunks, -1)
        if eps is None and generator is not None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        # std = exp(0.5 logvar) (vae.py:175-179)
        latent = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return latent, (mu, logvar), x.reshape(b, nframes, -1)

    def decode(self, z: torch.Tensor, nframes: int = 128) -> torch.Tensor:
        """z (2, B, n_chunks, D) -> motion (B, nframes, nfeats)."""
        _, b, _, d = z.shape
        queries = self.query_pos_decoder(
            torch.zeros(b, nframes, d, dtype=z.dtype, device=z.device))
        out_b = self.body_decoder(queries, self.mem_pos_decoder(z[0]))
        out_h = self.hands_decoder(queries, self.mem_pos_decoder(z[1]))
        return torch.cat([self.body_final_layer(out_b),
                          self.hands_final_layer(out_h)], dim=-1)
