"""Latent-diffusion denoiser transformer.

Port of ``Denoiser`` (``convofusion_tpu/models/denoiser.py:36-291``) and
``EmbedAction`` (:294-328).  Arch ``trans_dec`` (production):
``_embed_sample``, ``_build_memory``, ``__call__``, ``text_only`` and
``guided`` (:117-291):
  1. project the (B, 16, latent_dim) latent tokens to d
  2. sinusoidal timestep embedding -> 2-layer MLP -> (B, 1, d)
  3. add the body/hands token-type embedding (even/odd tokens) + sine_bh PE
  4. add time embedding + condition-id embedding + the memory PE (sine, or
     a learned table, ``position_embedding``; JAX :70-71) to each of the
     five condition streams
  5. run the 5-stream decoder stack; project back d -> latent_dim

Arch ``trans_enc`` (JAX :93-108, :140-160), the concat-conditioning
ablation: steps 1-3, then the condition tokens (plus the time embedding)
are appended to the latent tokens, the sine_bh PE goes over the whole
sequence, a skip encoder (``encoder``, at ``text_encoded_dim``, pre- or
post-norm) runs it and the latent tokens' outputs are projected back; no
attention maps.  Its condition is the five streams (``text+audio`` or any
other name but these), one text tensor ``text`` / ``text_uncond``
(``emb_proj``: ReLU then Linear) or action ids ``action`` (``emb_proj``:
:class:`EmbedAction`).  It has no ``decoder``, ``condition_embedding`` or
memory PE, so ``guided`` and ``text_only`` raise (JAX fails there on the
missing parameters).

``fuse_streams`` builds the trans_dec stack with the five cross-attentions
batched into one (``FusedDenoiserDecoder``; JAX :55-90): ``forward`` and
``text_only`` run the same math, and the guided path, which needs the
per-stream layers, raises (JAX asserts, :270-271).  ``remat``
recomputes each layer's activations in a training backward pass.

``GuidedGraphs`` replays ``guided`` from CUDA graphs: one capture of the
whole 7-branch call (~1,800 small kernels) per input geometry, then one
graph launch a reverse step in place of the kernels' launches one by one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
from torch import nn

from convofusion_tpu_torch.ops import layer_norm
from convofusion_tpu_torch.ops.embeddings import TimestepEmbedding, Timesteps
from convofusion_tpu_torch.ops.layers import Embedding, Linear, dropout_mask
from convofusion_tpu_torch.ops.positional import (
    PositionEmbeddingSineBH,
    build_position_encoding,
)
from convofusion_tpu_torch.ops.transformer import (
    COND_STREAMS,
    NUM_BRANCHES,
    DenoiserDecoder,
    FusedDenoiserDecoder,
    SkipTransformerEncoder,
)
from convofusion_tpu_torch.utils import cuda_graphs, profiling

ARCHS = ("trans_dec", "trans_enc")
# the conditions trans_enc takes as one tensor (JAX :109-116, :148-153);
# any other name means the five streams
TEXT_CONDITIONS = ("text", "text_uncond")
ONE_TENSOR_CONDITIONS = TEXT_CONDITIONS + ("action",)


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
                 fuse_streams: bool = False, remat: bool = False,
                 arch: str = "trans_dec", condition: str = "text+audio",
                 nclasses: int = 10):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"model.denoiser.params.arch {arch!r}: not one "
                             f"of {ARCHS}")
        d = text_encoded_dim
        self.arch = arch
        self.condition = condition
        self.latent_embd = Linear(latent_dim, d, dtype=dtype)
        self.latent_proj = Linear(d, latent_dim, dtype=dtype)
        self.time_proj = Timesteps(d, flip_sin_to_cos, freq_shift)
        self.time_embedding = TimestepEmbedding(d, d)
        self.query_pos = PositionEmbeddingSineBH(d)
        self.bh_embedding = Embedding(2, d, dtype=dtype)
        self.fuse_streams = bool(fuse_streams)
        stack = dict(num_layers=num_layers, nhead=num_heads,
                     dim_feedforward=ff_size, activation=activation,
                     normalize_before=normalize_before, dtype=dtype,
                     dropout=dropout)
        if arch == "trans_dec":
            self.mem_pos = build_position_encoding(d, position_embedding)
            self.condition_embedding = Embedding(len(COND_STREAMS), d,
                                                 dtype=dtype)
            decoder_cls = (FusedDenoiserDecoder if self.fuse_streams
                           else DenoiserDecoder)
            self.decoder = decoder_cls(d_model=d, remat=remat, **stack)
        else:
            # JAX builds the encoder at text_encoded_dim (the reference's
            # latent_dim only type-checks when the two are equal, :99-103)
            self.encoder = SkipTransformerEncoder(d_model=d, **stack)
            if condition in TEXT_CONDITIONS:
                # reference names: emb_proj.1 is the Linear (:109-112)
                self.emb_proj = nn.Sequential(nn.ReLU(),
                                              Linear(d, d, dtype=dtype))
            elif condition == "action":
                self.emb_proj = EmbedAction(nclasses, d, dtype=dtype)

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
        (noise_pred, att[stream] (B, L, T, Tk)).  With ``trans_enc``,
        ``cond`` is the condition's tensor (text (B, Tk, d), action ids
        (B, 1)) or the five streams, masks are not read and att is {}."""
        x, time_emb = self._embed_sample(sample, timesteps)
        if self.arch == "trans_enc":
            return self._forward_trans_enc(x, time_emb, cond)
        mem = self._build_memory(cond, time_emb, _is_scalar(timesteps))
        out, att = self.decoder(x, mem, time_emb, cond_masks)
        return self.latent_proj(out), att

    def _forward_trans_enc(self, x, time_emb, cond):
        """The concat-conditioning encoder (JAX :140-160)."""
        n_sample = x.shape[1]
        if self.condition in ONE_TENSOR_CONDITIONS:
            seq = [x, time_emb + self.emb_proj(cond)]
        else:
            seq = [x] + [cond[s] + time_emb for s in COND_STREAMS]
        # torch.cat promotes mixed dtypes as jnp.concatenate does
        tokens = self.encoder(self.query_pos(torch.cat(seq, dim=1)))
        return self.latent_proj(tokens[:, :n_sample]), {}

    def _require_decoder(self, what: str) -> None:
        if self.arch == "trans_enc":
            raise ValueError(
                f"{what} needs the trans_dec decoder; arch 'trans_enc' has "
                f"none (JAX fails on the missing parameters)")

    def _per_stream(self, what: str) -> None:
        self._require_decoder(what)
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
        self._require_decoder("text_only")
        if not _is_scalar(timesteps):
            raise ValueError("text_only takes a scalar timestep")
        return self.forward(sample, timesteps, cond, cond_masks)

    def guided(self, sample, timesteps, cond_real, cond_unc,
               masks_real=None, masks_unc=None):
        """All 7 classifier-free-guidance branches at once.  Returns
        (noise_pred (7, B, T, latent_dim), att[stream] (B, L, T, Tk) of the
        full-condition branch)."""
        self._per_stream("guided")
        x, time_emb = self._embed_sample(sample, timesteps)
        x7 = x[None].expand((NUM_BRANCHES,) + x.shape)
        shared = _is_scalar(timesteps)
        mem_real = self._build_memory(cond_real, time_emb, shared)
        # single-row uncond conditions (encode_uncond) keep the uncond
        # memory at batch 1 through LayerNorm + K/V; grouped_attend
        # broadcasts the shared keys/values
        mem_unc = self._build_memory(cond_unc, time_emb, shared)
        out7, att = self.decoder.guided(x7, mem_real, mem_unc, time_emb,
                                        masks_real, masks_unc)
        # the stack's final norm, in latent_proj's dtype
        out7 = layer_norm.normalize(self.decoder.norm, out7, self.latent_proj)
        return self.latent_proj(out7), att


class GuidedGraph:
    """:meth:`Denoiser.guided` at one input geometry over static input
    buffers: captured by its first call, replayed by every call.  A call
    copies the latents in, fills the timestep and launches the graph; the
    conditions are copied in once a reverse loop (:meth:`bind`).  The
    outputs, (noise_pred7, att), are the graph's own tensors, in the pool
    the model's graphs share: the next replay of any of them may overwrite
    them."""

    def __init__(self, denoiser: Denoiser, pool: cuda_graphs.GraphPool,
                 latents, conditions: Dict):
        self._denoiser, self._pool = denoiser, pool
        self.latents = cuda_graphs.static_like(latents)
        # a 0-dim timestep is shared (_embed_sample): single-row uncond
        # memories stay at batch 1, as with a Python int
        self.t = cuda_graphs.static_like(
            latents.new_zeros((), dtype=torch.long))
        self.conditions = cuda_graphs.static_like(conditions)
        self._graph = self.outputs = None

    def bind(self, conditions: Dict) -> None:
        """Copies cond_real, cond_unc, masks_real, masks_unc in."""
        cuda_graphs.copy_into(self.conditions, conditions)

    def __call__(self, latents, t):
        self.latents.copy_(latents)
        self.t.fill_(t)
        if self._graph is None:
            # normal output tensors, as the inputs
            with torch.inference_mode(False), torch.no_grad():
                self._graph, self.outputs = self._pool.capture(
                    lambda: self._denoiser.guided(self.latents, self.t,
                                                  **self.conditions),
                    self.latents.device)
            profiling.count("denoiser.graph_captures")
        self._graph.replay()
        profiling.count("denoiser.graph_replays")
        return self.outputs


class GuidedGraphs:
    """A model's :class:`GuidedGraph` per input geometry (device, the
    latents' shape and dtype, each condition's and mask's shape and dtype)
    in a ``utils/cuda_graphs.LRU``, and the one memory pool their captures
    share.  ``weights_version`` is part of the key: a new version drops
    every graph, which read the old weights' storage.  One reverse loop at
    a time holds the graphs, since they share their pool; a loop in
    another thread meanwhile runs eagerly."""

    def __init__(self):
        self._graphs = cuda_graphs.LRU()
        self._version = None
        self._pool = cuda_graphs.GraphPool()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def bound(self, denoiser: Denoiser, weights_version: int, latents,
              cond_real, cond_unc, masks_real=None, masks_unc=None,
              placed: bool = False):
        """Yields ``run(latents, t) -> (noise_pred7, att)``, ``denoiser
        .guided`` over these conditions for the steps of one reverse loop:
        a graph's replay where the inputs allow capture, else the eager
        call, which counts ``denoiser.graph_eager``.  Eager: latents off a
        CUDA card, a condition off the latents' device, the module in
        training mode (dropout draws), grad enabled, a tensor-parallel
        placement (``placed``: its collectives stay eager), or another
        loop holding the graphs."""
        conditions = dict(cond_real=cond_real, cond_unc=cond_unc,
                          masks_real=masks_real, masks_unc=masks_unc)
        key = self._key(denoiser, latents, conditions, placed)
        if key is None or not self._lock.acquire(blocking=False):
            def run(lat, t):
                profiling.count("denoiser.graph_eager")
                return denoiser.guided(lat, t, **conditions)

            yield run
            return
        try:
            if weights_version != self._version:
                self._graphs.clear()
                self._version = weights_version
            graph = self._graphs.get(key, lambda: GuidedGraph(
                denoiser, self._pool, latents, conditions))
            graph.bind(conditions)
            yield graph
        finally:
            self._lock.release()

    @staticmethod
    def _key(denoiser, latents, conditions, placed):
        """The graph's key, or None where :meth:`bound` runs eagerly."""
        if (latents.device.type not in cuda_graphs.CAPTURE_DEVICES
                or denoiser.training or torch.is_grad_enabled() or placed):
            return None
        try:
            return latents.device, cuda_graphs.geometry(
                dict(conditions, latents=latents), latents.device)
        except cuda_graphs.Eager:
            return None


class EmbedAction(nn.Module):
    """Action-class condition (JAX :294-328): a row of the xavier table
    ``action_embedding`` for each item's first id, (B, 1, d).  In training
    (``guidance_uncondp`` > 0) whole rows are dropped by a Bernoulli draw
    from the ``dropout_generator`` in scope, or by ``drop`` (B,) bool when
    given; in eval with ``guidance_scale`` > 1 the first half of the batch
    is zeroed (the unconditional half of guided inference); ``force_mask``
    zeroes every row.  The table stays fp32 and the rows are cast to the
    compute dtype."""

    def __init__(self, num_actions: int, latent_dim: int,
                 guidance_scale: float = 7.5, guidance_uncondp: float = 0.1,
                 force_mask: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.action_embedding = nn.Parameter(
            torch.empty(num_actions, latent_dim))
        nn.init.xavier_uniform_(self.action_embedding)
        self.guidance_scale = float(guidance_scale)
        self.guidance_uncondp = float(guidance_uncondp)
        self.force_mask = bool(force_mask)
        self.dtype = dtype

    def forward(self, action, drop: Optional[torch.Tensor] = None):
        out = self.action_embedding[action[:, 0].long()]
        b = out.shape[0]
        if self.force_mask:
            out = torch.zeros_like(out)
        elif self.training and self.guidance_uncondp > 0.0:
            if drop is None:
                drop = dropout_mask((b, 1), self.guidance_uncondp,
                                    out.device)
            out = out * (1.0 - drop.reshape(b, 1).to(out.dtype))
        elif not self.training and self.guidance_scale > 1.0:
            half = torch.arange(b, device=out.device) < b // 2
            out = torch.where(half[:, None], 0.0, out)
        return out[:, None, :].to(self.dtype)
