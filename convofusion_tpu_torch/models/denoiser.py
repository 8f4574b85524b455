"""Latent-diffusion denoiser transformer (production ``trans_dec`` arch).

Port of ``Denoiser._embed_sample``, ``_build_memory``, ``__call__``,
``text_only``, ``precompute_step_kv``, ``forward_kv`` and ``guided``
(``convofusion_tpu/models/denoiser.py:117-291``):
  1. project the (B, 16, latent_dim) latent tokens to d
  2. sinusoidal timestep embedding -> 2-layer MLP -> (B, 1, d)
  3. add the body/hands token-type embedding (even/odd tokens) + sine_bh PE
  4. add time embedding + condition-id embedding + sine PE to each of the
     five condition streams
  5. run the 5-stream decoder stack; project back d -> latent_dim

``fuse_streams`` builds the stack with the five cross-attentions batched
into one (``FusedDenoiserDecoder``; JAX :55-90): ``forward`` and
``text_only`` run the same math, and the guided and K/V paths, which need
the per-stream layers, raise (JAX asserts, :270-271).  ``remat``
recomputes each layer's activations in a training backward pass.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from convofusion_tpu_torch.ops.embeddings import TimestepEmbedding, Timesteps
from convofusion_tpu_torch.ops.layers import Linear
from convofusion_tpu_torch.ops.positional import (
    PositionEmbeddingSine1D,
    PositionEmbeddingSineBH,
)
from convofusion_tpu_torch.ops.transformer import (
    COND_STREAMS,
    NUM_BRANCHES,
    DenoiserDecoder,
    FusedDenoiserDecoder,
)


def _is_scalar(timesteps) -> bool:
    return isinstance(timesteps, int) or (
        torch.is_tensor(timesteps) and timesteps.ndim == 0)


class Denoiser(nn.Module):
    def __init__(self, latent_dim: int = 128, text_encoded_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, normalize_before: bool = True,
                 activation: str = "gelu", flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, position_embedding: str = "sine",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 fuse_streams: bool = False, remat: bool = False):
        super().__init__()
        if position_embedding != "sine":
            raise NotImplementedError(
                f"memory PE {position_embedding!r} is not ported")
        d = text_encoded_dim
        self.latent_embd = Linear(latent_dim, d, dtype=dtype)
        self.latent_proj = Linear(d, latent_dim, dtype=dtype)
        self.time_proj = Timesteps(d, flip_sin_to_cos, freq_shift)
        self.time_embedding = TimestepEmbedding(d, d)
        self.query_pos = PositionEmbeddingSineBH(d)
        self.mem_pos = PositionEmbeddingSine1D(d)
        self.bh_embedding = nn.Embedding(2, d, dtype=dtype)
        self.condition_embedding = nn.Embedding(len(COND_STREAMS), d,
                                                dtype=dtype)
        self.fuse_streams = bool(fuse_streams)
        decoder_cls = (FusedDenoiserDecoder if self.fuse_streams
                       else DenoiserDecoder)
        self.decoder = decoder_cls(
            d_model=d, num_layers=num_layers, nhead=num_heads,
            dim_feedforward=ff_size, activation=activation,
            normalize_before=normalize_before, dtype=dtype, dropout=dropout,
            remat=remat)

    def _embed_sample(self, sample, timesteps):
        b, t, _ = sample.shape
        x = self.latent_embd(sample)
        if torch.is_tensor(timesteps):
            ts = timesteps.to(sample.device).reshape(-1).expand(b)
        else:
            ts = torch.full((b,), timesteps, device=sample.device)
        time_emb = self.time_embedding(
            self.time_proj(ts).to(x.dtype))[:, None, :]
        # token-type rows 0, 1, 0, 1, ... for the body/hands tokens
        bh = self.bh_embedding.weight.repeat((t + 1) // 2, 1)[:t]
        x = self.query_pos(x + bh[None])
        return x, time_emb

    def _build_memory(self, cond, time_emb, shared_time: bool):
        """With a shared timestep, a single-row stream (1, Tk, d) takes
        the time-embedding row [:1] and stays at batch 1."""
        mem = {}
        for i, stream in enumerate(COND_STREAMS):
            single = shared_time and cond[stream].shape[0] == 1
            m = cond[stream] + (time_emb[:1] if single else time_emb)
            m = m + self.condition_embedding.weight[i]
            mem[stream] = self.mem_pos(m)
        return mem

    def forward(self, sample, timesteps, cond: Dict[str, torch.Tensor],
                cond_masks: Optional[Dict[str, torch.Tensor]] = None):
        """sample (B, T, latent_dim); timesteps int, 0-dim or (B,);
        cond[stream] (B, Tk, d), or (1, Tk, d) shared by the batch;
        cond_masks[stream] (B or 1, Tk) bool, True = pad.  Returns
        (noise_pred, att[stream] (B, L, T, Tk))."""
        x, time_emb = self._embed_sample(sample, timesteps)
        mem = self._build_memory(cond, time_emb, _is_scalar(timesteps))
        out, att = self.decoder(x, mem, time_emb, cond_masks)
        return self.latent_proj(out), att

    def _per_stream(self, what: str) -> None:
        if self.fuse_streams:
            raise NotImplementedError(
                f"{what} runs the per-stream layer layout, not "
                f"fuse_streams (convofusion_tpu/models/denoiser.py:270-271)")

    def text_only(self, sample, timesteps, cond: Dict[str, torch.Tensor],
                  cond_masks: Optional[Dict[str, torch.Tensor]] = None):
        """``forward`` for the WEG text-only condition (guidance branch 1:
        tlsn real, the rest single uncond rows).  Needs a scalar timestep,
        so those rows stay at batch 1 (in the fused layout, up to the
        padded stack, where they are broadcast)."""
        if not _is_scalar(timesteps):
            raise ValueError("text_only takes a scalar timestep")
        return self.forward(sample, timesteps, cond, cond_masks)

    def precompute_step_kv(self, timesteps, cond_real, cond_unc):
        """Every layer's memory LayerNorm + K/V for both guidance variants
        at one scalar timestep: the latent-independent share of a step,
        for :meth:`guided` and :meth:`forward_kv` (``kvs=``).  The time
        embedding is one row, so single-row streams stay at batch 1."""
        self._per_stream("precompute_step_kv")
        if not _is_scalar(timesteps):
            raise ValueError("precompute_step_kv takes a scalar timestep")
        dev = self.latent_embd.weight.device
        ts = torch.as_tensor(timesteps, device=dev).reshape(1)
        time_emb = self.time_embedding(self.time_proj(ts).to(
            self.latent_embd.weight.dtype))[:, None, :]
        return self.decoder.precompute_kv(
            self._build_memory(cond_real, time_emb, True),
            self._build_memory(cond_unc, time_emb, True))

    def forward_kv(self, sample, timesteps, kvs, cond_masks=None,
                   select: Optional[Dict[str, str]] = None):
        """``forward`` over :meth:`precompute_step_kv`; ``select[stream]``
        in {'real', 'unc'} (the WEG text-only pass: tlsn 'real', the rest
        'unc', guidance branch 1)."""
        self._per_stream("forward_kv")
        x, time_emb = self._embed_sample(sample, timesteps)
        out, att = self.decoder.forward_kv(x, kvs, select, time_emb,
                                           cond_masks)
        return self.latent_proj(out), att

    def guided(self, sample, timesteps, cond_real, cond_unc,
               masks_real=None, masks_unc=None, kvs=None):
        """All 7 classifier-free-guidance branches at once.  ``kvs``
        (optional): :meth:`precompute_step_kv` at this timestep, which
        replaces the conditions.  Returns (noise_pred (7, B, T,
        latent_dim), att[stream] (B, L, T, Tk) of the full-condition
        branch)."""
        self._per_stream("guided")
        x, time_emb = self._embed_sample(sample, timesteps)
        x7 = x[None].expand((NUM_BRANCHES,) + x.shape)
        if kvs is None:
            shared = _is_scalar(timesteps)
            mem_real = self._build_memory(cond_real, time_emb, shared)
            # single-row uncond conditions (encode_uncond) keep the uncond
            # memory at batch 1 through LayerNorm + K/V; grouped_attend
            # broadcasts the shared keys/values
            mem_unc = self._build_memory(cond_unc, time_emb, shared)
        else:
            mem_real = mem_unc = None
        out7, att = self.decoder.guided(x7, mem_real, mem_unc, time_emb,
                                        masks_real, masks_unc, kvs)
        return self.latent_proj(out7), att
