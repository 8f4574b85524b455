"""Chunked body/hands motion VAE.

Port of ``ConvoFusionVae`` (``convofusion_tpu/models/vae.py:35-218``):

- ``encode``: each 128-frame clip is cut into 8 chunks of 16 frames; each
  chunk's root x/z is taken back to its first frame; learnable query tokens
  are put before the 16 embedded frames of each part, plus the PE, through
  one skip encoder per part.  Without ``mlp_dist`` there are two tokens a
  latent, whose outputs are (mu, logvar); with it (``TRAIN.ABLATION.
  MLP_DIST``, JAX :88-100, :146-160) one token a latent, whose output a
  Linear d -> 2d head (``body_dist_layer`` / ``hands_dist_layer``) splits
  into mu and logvar.  The sample is ``mu + exp(0.5 logvar) * eps``.
- ``decode``, arch ``encoder_decoder`` (production): 128 zero queries plus
  the PE cross-attend, through one skip decoder per part, to the 8 chunk
  latents plus the memory PE; the whole clip's queries attend to all 8
  chunk latents jointly.  Arch ``all_encoder`` (JAX :78-84, :197-210): the
  part's "decoder" is a skip encoder over [8 latents; 128 zero queries] +
  the query PE, whose last 128 outputs are kept.
- the PEs are ``position_embedding``'s (sine, or a learned table each,
  JAX ``ops/positional.py:60-86``); the layers are pre-norm or post-norm
  (``normalize_before``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from convofusion_tpu_torch.ops.layers import Linear
from convofusion_tpu_torch.ops.positional import build_position_encoding
from convofusion_tpu_torch.ops.transformer import (
    SkipTransformerDecoder,
    SkipTransformerEncoder,
)

BODY_NFEATS = 23 * 3
HANDS_NFEATS = 40 * 3
CHUNK_LEN = 16
PARTS = ("body", "hands")


ARCHS = ("encoder_decoder", "all_encoder")


class ConvoFusionVae(nn.Module):
    def __init__(self, latent_dim: int = 128, ff_size: int = 1024,
                 num_layers: int = 5, num_heads: int = 2,
                 arch: str = "encoder_decoder", normalize_before: bool = True,
                 activation: str = "gelu", position_embedding: str = "sine",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 latent_size: int = 1, mlp_dist: bool = False):
        super().__init__()
        if arch not in ARCHS:
            # JAX raises ValueError("Not support architecture!") (:85-86)
            raise ValueError(f"model.motion_vae.params.arch {arch!r}: not "
                             f"one of {ARCHS}")
        d = latent_dim
        self.arch = arch
        self.latent_size = latent_size
        self.mlp_dist = bool(mlp_dist)
        # the output tokens that carry the posterior
        self.n_tok = latent_size if self.mlp_dist else 2 * latent_size
        self.query_pos_encoder = build_position_encoding(d, position_embedding)
        self.query_pos_decoder = build_position_encoding(d, position_embedding)
        kw = dict(d_model=d, num_layers=num_layers, nhead=num_heads,
                  dim_feedforward=ff_size, activation=activation,
                  normalize_before=normalize_before, dtype=dtype,
                  dropout=dropout)
        self.body_encoder = SkipTransformerEncoder(**kw)
        self.hands_encoder = SkipTransformerEncoder(**kw)
        if arch == "encoder_decoder":
            # all_encoder never reads a memory PE: JAX has no table for it
            self.mem_pos_decoder = build_position_encoding(
                d, position_embedding)
            self.body_decoder = SkipTransformerDecoder(**kw)
            self.hands_decoder = SkipTransformerDecoder(**kw)
        else:
            self.body_decoder = SkipTransformerEncoder(**kw)
            self.hands_decoder = SkipTransformerEncoder(**kw)
        # query tokens: fp32 parameters used without a cast, as the JAX
        # module's (vae.py:91-96), drawn N(0, 1)
        for part in PARTS:
            setattr(self, f"{part}_global_motion_token", nn.Parameter(
                torch.randn(self.n_tok, d)))
            if self.mlp_dist:
                setattr(self, f"{part}_dist_layer",
                        Linear(d, 2 * d, dtype=dtype))
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

        mus, logvars = [], []
        ls = self.latent_size
        for part, feats in (("body", x[:, :, :BODY_NFEATS]),
                            ("hands", x[:, :, BODY_NFEATS:])):
            dist = getattr(self, f"{part}_global_motion_token")
            emb = getattr(self, f"{part}_skel_embedding")(feats)
            seq = torch.cat([dist.expand(b * n_chunks, -1, -1),
                             emb.to(dist.dtype)], dim=1)
            tok = getattr(self, f"{part}_encoder")(
                self.query_pos_encoder(seq))[:, :self.n_tok]
            if self.mlp_dist:
                # the Linear d -> 2d head splits mu and logvar (vae.py:
                # 146-152)
                mu, logvar = getattr(self, f"{part}_dist_layer")(
                    tok).chunk(2, dim=-1)
            else:
                mu, logvar = tok[:, :ls], tok[:, ls:]
            mus.append(mu)
            logvars.append(logvar)
        mu = torch.stack(mus, dim=0).reshape(2, b, n_chunks, -1)
        logvar = torch.stack(logvars, dim=0).reshape(2, b, n_chunks, -1)
        if eps is None and generator is not None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        # std = exp(0.5 logvar) (vae.py:175-179)
        latent = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return latent, (mu, logvar), x.reshape(b, nframes, -1)

    def decode(self, z: torch.Tensor, nframes: int = 128) -> torch.Tensor:
        """z (2, B, n_chunks, D) -> motion (B, nframes, nfeats)."""
        _, b, n_chunks, d = z.shape
        queries = torch.zeros(b, nframes, d, dtype=z.dtype, device=z.device)
        if self.arch == "encoder_decoder":
            queries = self.query_pos_decoder(queries)
            out_b = self.body_decoder(queries, self.mem_pos_decoder(z[0]))
            out_h = self.hands_decoder(queries, self.mem_pos_decoder(z[1]))
        else:
            # all_encoder: [latents; zero queries] + PE, the query suffix
            # kept (vae.py:197-210)
            out_b, out_h = (
                dec(self.query_pos_decoder(torch.cat([zp, queries], dim=1))
                    )[:, n_chunks:]
                for dec, zp in ((self.body_decoder, z[0]),
                                (self.hands_decoder, z[1])))
        return torch.cat([self.body_final_layer(out_b),
                          self.hands_final_layer(out_h)], dim=-1)
