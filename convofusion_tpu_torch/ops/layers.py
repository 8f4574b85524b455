"""Dense, LayerNorm and Embed with the JAX package's dtype rules, dropout,
and the seeded weight init.

The JAX modules keep fp32 parameters and take a ``dtype`` (compute dtype):
``nn.Dense(dtype=bf16)`` casts its input and kernel to bf16 and returns bf16;
``nn.Embed(dtype=bf16)`` returns bf16 rows; ``nn.LayerNorm()`` with no dtype
promotes a bf16 input against its fp32 scale and returns fp32
(``convofusion_tpu/ops/transformer.py:291-302``).  Here a ``Linear`` or an
``nn.Embedding`` stores its weight in the compute dtype (rounding once what
flax rounds at every use) and a ``LayerNorm`` keeps fp32 weights and
computes and returns fp32.  Dropout masks come from the generator that
``dropout_generator`` scopes around a forward pass (the training losses set
the step's generator); ``checkpointed`` recomputes a layer in the backward
pass with the masks of its forward.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


# False while a seeded model is built: its init_weights overwrites every
# Linear and Embedding weight and every packed attention projection, so
# their constructors skip PyTorch's default draws (a context variable: per
# thread, reset when the block exits)
_DEFAULT_INIT: contextvars.ContextVar = contextvars.ContextVar(
    "default_init", default=True)


@contextlib.contextmanager
def default_init(enabled: bool):
    """Inside the block, :class:`Linear`, :class:`Embedding` and the port's
    attention draw PyTorch's default init only if ``enabled``; a model whose
    :func:`init_weights` follows passes False and is built without those
    draws (the same weights, ~40% less construction time)."""
    token = _DEFAULT_INIT.set(bool(enabled))
    try:
        yield
    finally:
        _DEFAULT_INIT.reset(token)


def default_init_enabled() -> bool:
    return _DEFAULT_INIT.get()


class Linear(nn.Linear):
    """``nn.Dense(dtype=...)``: the input is cast to the weight's dtype."""

    def reset_parameters(self):
        if _DEFAULT_INIT.get():
            super().reset_parameters()

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose default init :func:`default_init` can skip."""

    def reset_parameters(self):
        if _DEFAULT_INIT.get():
            super().reset_parameters()


# the generator dropout masks draw from, set by `dropout_generator` for the
# extent of one forward pass (a context variable: per thread, and reset when
# the block exits)
_DROPOUT_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator):
    """Inside the block, every training :class:`Dropout` draws its mask from
    ``generator`` (as JAX splits each step's dropout key off the step's
    key, convofusion_tpu/train/trainer.py:159-161); None leaves the default
    generator of the input's device."""
    token = _DROPOUT_GENERATOR.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GENERATOR.reset(token)


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), for per-layer
    rematerialisation.  The recompute's dropout masks come from a copy of
    the enclosing :func:`dropout_generator`'s generator at the state the
    forward saw, so they equal the forward's and the generator advances
    once, as without the checkpoint (flax's ``nn.remat`` redraws the same
    masks from the key); without one, the checkpoint's
    ``preserve_rng_state`` replays the default generators."""
    gen = _DROPOUT_GENERATOR.get()
    state = None if gen is None else gen.get_state()
    calls = []

    def run(*a):
        if not calls:               # the forward: the live generator
            calls.append(True)
            return fn(*a)
        replay = None
        if gen is not None:
            replay = torch.Generator(device=gen.device)
            replay.set_state(state)
        with dropout_generator(replay):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class Dropout(nn.Module):
    """``nn.Dropout(rate)(x, deterministic=not training)``: the identity,
    with no op launched, unless the module trains and ``p > 0``.  The mask
    is a Bernoulli(1 - p) draw from the generator of the enclosing
    :func:`dropout_generator` block, and the kept values are scaled by
    1 / (1 - p)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if self.training and self.p > 0.0:
            keep = 1.0 - self.p
            mask = torch.empty_like(x).bernoulli_(
                keep, generator=_DROPOUT_GENERATOR.get())
            return (x * mask).mul_(1.0 / keep)
        return x

    def extra_repr(self) -> str:
        return f"p={self.p}"


def dropout_mask(shape, p: float, device) -> torch.Tensor:
    """A fp32 Bernoulli(``p``) draw of ``shape`` (1 = drop) from the
    generator of the enclosing :func:`dropout_generator` block."""
    return torch.empty(shape, device=device).bernoulli_(
        p, generator=_DROPOUT_GENERATOR.get())


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(epsilon=1e-5)``: fp32 weights, fp32 math and output."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__(d, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


# ops/fused_streams.FusedCrossStreams's parameters
_STACKED_KERNELS = {f"{p}_kernel" for p in "qkvo"}
_STACKED_BIASES = {f"{p}_bias" for p in "qkvo"} | {"ln_bias"}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init at the scale of the flax defaults: Dense kernels lecun
    normal (std 1/sqrt(fan_in)), zero biases, Embed rows std
    1/sqrt(features), norms at one (T5LayerNorm starts at one and is left
    alone), the fused cross-attentions' stacked kernels as Dense kernels,
    the VAE's global motion tokens std 1 (flax ``normal(1.0)``,
    convofusion_tpu/models/vae.py:91-96), a learned PE table U(0, 1)
    (ops/positional.py:60-72), the action table xavier uniform
    (models/denoiser.py:308-310).  Values are drawn in fp32 on the CPU
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
            elif name == "pe":              # a learned PE table: U(0, 1)
                with torch.no_grad():
                    p.copy_(torch.rand(p.shape, generator=generator))
            elif name == "action_embedding":   # xavier uniform
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                with torch.no_grad():
                    p.copy_((2 * torch.rand(p.shape, generator=generator)
                             - 1) * bound)
            # the fused cross-attentions' stacked (S, D_in, D_out) kernels
            elif name in _STACKED_KERNELS:
                fill(p, 1.0 / math.sqrt(p.shape[-2]))
            elif name in _STACKED_BIASES:
                nn.init.zeros_(p)
            elif name == "ln_scale":
                nn.init.ones_(p)
