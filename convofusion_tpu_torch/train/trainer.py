"""Training loop: AdamW with optax's semantics on the trainable parameters,
fp32 master weights, and the step loop.

Port of ``convofusion_tpu/train/trainer.py`` (single device; the data-
parallel mesh is not ported).

- ``frozen_names``: the T5 trunk never trains (reference t5.py:35-37), and
  stage 2 freezes the whole VAE (reference convofusion.py:78-82).  Frozen
  parameters get no update and no weight decay, and no optimizer state.
- ``AdamW``: ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
  decay) after ``optax.clip_by_global_norm`` when ``grad_clip`` > 0, with a
  constant or ``warmup_cosine_decay_schedule`` learning rate.  The step
  count, the bias corrections and the learning rate are host numbers, so a
  step reads nothing from the card; the clip decides on the card.
- ``Trainer``: each trainable parameter has an fp32 master and fp32
  moments.  A step casts each ``.grad`` to fp32, steps the masters, and
  copies the masters back, rounded, into the model's parameters; an fp32
  parameter is its own master.  That is what JAX computes for fp32
  parameters cast to bf16 at each use: the cast's VJP rounds the cotangent
  to bf16, and the fp32 parameter steps.  The model keeps its compute-
  dtype weights, so every sampling path runs as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from convofusion_tpu_torch.models.convofusion import Convofusion


def frozen_names(stage: str) -> Tuple[str, ...]:
    """Module names whose parameters never train in ``stage``."""
    names = ("text_encoder.text_model",)
    if stage == "diffusion":
        names += ("vae",)
    return names


def trainable_parameters(model: nn.Module, stage: str
                         ) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of every parameter outside ``frozen_names``."""
    frozen = frozen_names(stage)
    return [(n, p) for n, p in model.named_parameters()
            if not any(n == f or n.startswith(f + ".") for f in frozen)]


def make_schedule(optim: Dict) -> Callable[[int], float]:
    """The learning rate at a step count (optax's ``count``: the number of
    updates made before this one)."""
    lr = float(optim["lr"])
    sched = str(optim.get("schedule", "constant")).lower()
    if sched == "constant":
        return lambda count: lr
    if sched != "cosine":
        raise NotImplementedError(
            f"TRAIN.OPTIM.SCHEDULE={sched!r} (constant | cosine)")
    warm = int(optim.get("warmup_steps", 0))
    decay = int(optim.get("decay_steps", 10_000)) - warm
    if decay <= 0:
        raise ValueError("the cosine schedule needs decay_steps > "
                         "warmup_steps")
    end = lr * float(optim.get("end_lr_factor", 0.0))
    init = 0.0 if warm else lr
    alpha = 0.0 if lr == 0.0 else end / lr

    def schedule(count: int) -> float:
        # optax.warmup_cosine_decay_schedule: a linear ramp from init to
        # lr over `warm` steps, then cosine decay to `end`
        if count < warm:
            return (init - lr) * (1.0 - count / warm) + lr
        c = min(count - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class AdamWState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


class AdamW:
    """``optax.chain(clip_by_global_norm(c), adamw(schedule, wd))`` over a
    list of fp32 tensors, with ``torch._foreach`` ops."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, optim: Dict):
        if str(optim.get("type", "adamw")).lower() != "adamw":
            raise NotImplementedError(
                "Do not support other optimizer for now.")
        self.schedule = make_schedule(optim)
        self.weight_decay = float(optim.get("weight_decay", 1e-2))
        self.grad_clip = float(optim.get("grad_clip", 0.0))

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``optax.clip_by_global_norm``: the gradients unchanged when
        their global norm is below ``grad_clip``, else g / norm * c, decided
        on the device (``clip_grad_norm_`` would divide by norm + 1e-6)."""
        grads = list(grads)
        if not self.grad_clip:
            return grads
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        return torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, one * self.grad_clip))

    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The updates to add to ``params``; advances ``state``."""
        grads = self.clip(grads)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        lr = self.schedule(state.count)
        state.count += 1
        # bias corrections 1 - b**count in fp32, as optax computes them
        f32 = np.float32
        bc1 = float(f32(1.0) - np.power(f32(b1), f32(state.count)))
        bc2 = float(f32(1.0) - np.power(f32(b2), f32(state.count)))
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, list(params),
                                alpha=self.weight_decay)
        torch._foreach_mul_(updates, -lr)
        return updates


def make_optimizer(cfg: Dict) -> AdamW:
    """The optimizer of ``cfg['train']['optim']`` (JAX :43-77); the
    trainer hands it the trainable parameters only."""
    return AdamW(cfg["train"]["optim"])


class Trainer:
    """Stage-aware trainer over a :class:`Convofusion` built with that
    stage (``model.stage``).  ``cfg`` defaults to the model's; its
    ``train['optim']`` block configures the optimizer.  Call
    :meth:`init_state` after loading weights (:meth:`fit_steps` and
    :meth:`train_step` call it on first use)."""

    def __init__(self, model: Convofusion, cfg: Optional[Dict] = None):
        self.model = model
        self.cfg = model.cfg if cfg is None else cfg
        self.stage = model.stage
        self.optimizer = make_optimizer(self.cfg)
        named = trainable_parameters(model, self.stage)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.masters: Optional[List[torch.Tensor]] = None
        self.state: Optional[AdamWState] = None

    def state_dict(self) -> Dict:
        """The optimizer's state by parameter name: the fp32 masters, the
        moments ``mu`` and ``nu``, and the step ``count``."""
        if self.state is None:
            raise RuntimeError("no optimizer state yet: call init_state()")
        return {"masters": dict(zip(self.names, self.masters)),
                "mu": dict(zip(self.names, self.state.mu)),
                "nu": dict(zip(self.names, self.state.nu)),
                "count": self.state.count}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output: the masters, the moments and
        the count, then the model's lower-precision weights rounded from the
        masters.  Raises ``KeyError`` or ``ValueError``, and changes
        nothing, when the names or shapes differ from this trainer's."""
        for part in ("masters", "mu", "nu"):
            got = set(state[part])
            if got != set(self.names):
                raise KeyError(
                    f"trainer state '{part}' names differ: "
                    f"{sorted(got ^ set(self.names))[:4]}")
            for n, p in zip(self.names, self.params):
                if tuple(state[part][n].shape) != tuple(p.shape):
                    raise ValueError(f"trainer state '{part}' {n}: shape "
                                     f"{tuple(state[part][n].shape)}, the "
                                     f"parameter's {tuple(p.shape)}")
        if self.state is None:
            self.init_state()
        with torch.no_grad():
            for part, dst in (("masters", self.masters),
                              ("mu", self.state.mu), ("nu", self.state.nu)):
                torch._foreach_copy_(dst, [state[part][n].to(d.device)
                                           for n, d in zip(self.names, dst)])
            if self._lowp:
                torch._foreach_copy_([p for p, _ in self._lowp],
                                     [m for _, m in self._lowp])
        self.state.count = int(state["count"])
        self.model.weights_version += 1

    def loss_fn(self):
        m = self.model
        return {"vae": m.train_vae_loss,
                "vae_diffusion": m.train_vae_diffusion_loss}.get(
                    self.stage, m.train_diffusion_loss)

    def init_state(self, weights: Optional[Dict[str, torch.Tensor]] = None
                   ) -> AdamWState:
        """fp32 masters of the trainable parameters and zero moments.

        A master is the parameter itself in fp32, or, where ``weights`` (a
        state dict in the model's names) holds the parameter, that tensor
        in fp32: a bf16 model loaded from fp32 weights then trains from
        those fp32 values, as JAX's fp32 parameters do, not from their
        bf16 rounding."""
        weights = weights or {}
        masters = []
        for n, p in zip(self.names, self.params):
            w = weights.get(n)
            if w is None:
                masters.append(p.detach() if p.dtype == torch.float32
                               else p.detach().float())
                continue
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"init_state: {n} has shape "
                                 f"{tuple(w.shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            w = w.detach().to(p.device, torch.float32)
            if p.dtype == torch.float32:
                with torch.no_grad():
                    p.copy_(w)
                masters.append(p.detach())
            else:
                masters.append(w.clone())
        self.masters = masters
        self._lowp = [(p, m) for p, m in zip(self.params, self.masters)
                      if p.dtype != torch.float32]
        if self._lowp:
            with torch.no_grad():
                torch._foreach_copy_([p for p, _ in self._lowp],
                                     [m for _, m in self._lowp])
        self.state = self.optimizer.init(self.masters)
        return self.state

    @contextlib.contextmanager
    def training(self):
        """The model in train mode with the trainable parameters requiring
        grad; as it was afterwards.  The stage-2 loss runs the frozen VAE in
        eval mode itself; the frozen T5 trunk has no dropout."""
        model = self.model
        was_training = model.training
        saved = [(p, p.requires_grad) for p in model.parameters()]
        model.train()
        for p in self.params:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                yield
        finally:
            for p, flag in saved:
                p.requires_grad_(flag)
                p.grad = None
            model.train(was_training)

    def compute_grads(self, batch, generator: Optional[torch.Generator]
                      = None, draws: Optional[Dict] = None):
        """The stage's loss and its backward, leaving ``.grad`` on the
        trainable parameters; inside :meth:`training`.  Returns (loss,
        terms), detached 0-dim tensors."""
        loss, terms = self.loss_fn()(batch, generator, draws)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    def apply_grads(self):
        """One AdamW step of the masters from the ``.grad`` in fp32 (zero
        where a parameter got none), then the rounded masters into the
        model's parameters."""
        grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                 for p, m in zip(self.params, self.masters)]
        with torch.no_grad():
            updates = self.optimizer.update(grads, self.state, self.masters)
            torch._foreach_add_(self.masters, updates)
            if self._lowp:
                torch._foreach_copy_([p for p, _ in self._lowp],
                                     [m for _, m in self._lowp])
        for p in self.params:
            p.grad = None
        # cached uncond encodes (CachedSampler) belong to the old weights
        self.model.weights_version += 1

    def train_step(self, batch, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None):
        """One step; returns (loss, terms) as device tensors."""
        if self.state is None:
            self.init_state()
        with self.training():
            loss, terms = self.compute_grads(batch, generator, draws)
            self.apply_grads()
        return loss, terms

    def fit_steps(self, batches, generator: Optional[torch.Generator] = None,
                  log_every: int = 10,
                  draws: Optional[Sequence[Optional[Dict]]] = None
                  ) -> List[float]:
        """Train on a sequence of batches; ``draws[i]`` (optional) replaces
        step i's draws.  The loss of every ``log_every``-th step stays on
        the device and is copied to the host once, at the end."""
        if self.state is None:
            self.init_state()
        history = []
        with self.training():
            for i, batch in enumerate(batches):
                loss, _ = self.compute_grads(
                    batch, generator, None if draws is None else draws[i])
                self.apply_grads()
                if (i + 1) % log_every == 0:
                    history.append(loss)
        return torch.stack(history).tolist() if history else []
