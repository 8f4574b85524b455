"""Training loop: AdamW with optax's semantics on the trainable parameters,
fp32 master weights, and the step loop.

Port of ``convofusion_tpu/train/trainer.py``.  Under a
``torch.distributed`` group (``parallel/mesh.py``) each rank computes its
share of the global batch, and ``compute_grads`` averages the trainable
gradients, the loss and its terms over the ranks in fp32, in one flattened
bucket, before the optimizer's global-norm clip sees them: what JAX's
``psum`` over the data mesh gives.  Frozen subtrees take part in no
collective; with one rank the mean of one copy changes no bit.

With a ('data', 'model') mesh (``parallel/mesh.create_mesh``) the Trainer
places the model by JAX's tensor-parallel rules (``parallel/tp.py``) and
does what optax does over sharded arrays: each rank keeps masters and
moments for the elements it holds, the gradient mean runs over the 'data'
axis alone, and ``clip_by_global_norm`` sees the global norm, the squares
of split tensors summed over the 'model' axis and the replicated ones
counted once.

- ``frozen_names``: the T5 trunk never trains (reference t5.py:35-37), and
  stage 2 freezes the whole VAE (reference convofusion.py:78-82).  Frozen
  parameters get no update and no weight decay, and no optimizer state.
- ``AdamW``: ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
  decay) after ``optax.clip_by_global_norm`` when ``grad_clip`` > 0, with a
  constant or ``warmup_cosine_decay_schedule`` learning rate.  The step
  count, the bias corrections and the learning rate are host numbers, so a
  step reads nothing from the card; the clip decides on the card.  The
  trainer hands the learning rate and the bias corrections to the update
  as 0-dim device tensors, filled before each step, so that one captured
  update serves every step.
- ``Trainer``: each trainable parameter has an fp32 master and fp32
  moments.  A step reads each ``.grad`` as fp32, steps the masters, and
  copies the masters back, rounded, into the model's parameters; an fp32
  parameter is its own master.  On a CUDA card that step is one pass of
  the hand-written kernel (``ops/adamw.py``), elsewhere the
  ``torch._foreach`` chain.  That is what JAX computes for fp32
  parameters cast to bf16 at each use: the cast's VJP rounds the cotangent
  to bf16, and the fp32 parameter steps.  The model keeps its compute-
  dtype weights, so every sampling path runs as before.  On a CUDA card
  a step replays two CUDA graphs per input geometry
  (``train/step_graphs.py``) where the inputs allow capture, and runs
  eagerly elsewhere.
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
from convofusion_tpu_torch.ops import adamw
from convofusion_tpu_torch.parallel import mesh, tp
from convofusion_tpu_torch.train.step_graphs import StepGraphs
from convofusion_tpu_torch.utils import profiling


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
    list of fp32 tensors, with ``torch._foreach`` ops (``ops/adamw.py``'s
    plain version)."""

    b1, b2, eps = adamw.B1, adamw.B2, adamw.EPS

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

    def clip(self, grads: Sequence[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``optax.clip_by_global_norm`` at ``grad_clip``
        (``adamw.clip_by_global_norm``)."""
        return adamw.clip_by_global_norm(grads, self.grad_clip, norm)

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """(-learning rate, 1 - b1**t, 1 - b2**t) of the update after
        ``count`` updates (t = count + 1), host numbers; the bias
        corrections in fp32, as optax computes them."""
        f32 = np.float32
        t = f32(count + 1)
        return (-self.schedule(count),
                float(f32(1.0) - np.power(f32(self.b1), t)),
                float(f32(1.0) - np.power(f32(self.b2), t)))

    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor],
               norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """The updates to add to ``params``; advances ``state``.  ``norm``:
        the gradients' global norm where ``grads`` are shards of it."""
        scalars = self.scalars(state.count)
        state.count += 1
        return self.step(grads, state, params, scalars, norm)

    def step(self, grads: Sequence[torch.Tensor], state: AdamWState,
             params: Sequence[torch.Tensor], scalars,
             norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """:meth:`update`'s work on the device, leaving ``state.count`` as
        it is: ``scalars`` is :meth:`scalars` of the count, as host
        numbers or as 0-dim fp32 tensors on the device, which give the
        same bits."""
        return adamw.adamw_updates(self.clip(grads, norm), state.mu,
                                   state.nu, params, scalars,
                                   self.weight_decay)


def make_optimizer(cfg: Dict) -> AdamW:
    """The optimizer of ``cfg['train']['optim']`` (JAX :43-77); the
    trainer hands it the trainable parameters only."""
    return AdamW(cfg["train"]["optim"])


class Trainer:
    """Stage-aware trainer over a :class:`Convofusion` built with that
    stage (``model.stage``).  ``cfg`` defaults to the model's; its
    ``train['optim']`` block configures the optimizer.  Call
    :meth:`init_state` after loading weights (:meth:`fit_steps` and
    :meth:`train_step` call it on first use).  ``mesh`` (a ('data',
    'model') ``DeviceMesh``) places the model by the tensor-parallel rules
    first (``parallel/tp.apply_tp``); the trainer then steps this rank's
    shards."""

    def __init__(self, model: Convofusion, cfg: Optional[Dict] = None,
                 mesh=None):
        self.model = model
        self.cfg = model.cfg if cfg is None else cfg
        self.stage = model.stage
        self.optimizer = make_optimizer(self.cfg)
        if mesh is not None:
            tp.apply_tp(model, mesh)
        # the 'model' axis and each trainable parameter's placement on it
        self.axis = tp.model_axis(model)
        named = trainable_parameters(model, self.stage)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.placements = [model.tp_placements[n][1] if self.axis else None
                           for n in self.names]
        self.masters: Optional[List[torch.Tensor]] = None
        self.state: Optional[AdamWState] = None
        # the rank-averaged fp32 gradients of the last compute_grads
        self._reduced: Optional[List[torch.Tensor]] = None
        # a layer recomputed in the backward pass copies the mask
        # generator's state (ops/layers.checkpointed): no capture
        self.remat = any(getattr(m, "remat", False)
                         for m in model.modules())
        # the step's graph pairs, and the pair the last compute_grads used
        self.graphs = StepGraphs()
        self._graph = None
        # the AdamW kernel's work lists of the eager steps' gradients; its
        # compile overlaps the set-up before the first step
        self._tables = adamw.TableCache()
        if model.device.type == "cuda":
            adamw.start_build()
        # AdamW.scalars of each step: -lr, the two bias corrections
        self._scalars: List[torch.Tensor] = []

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
            self._round_weights()
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
        bf16 rounding.  On a placed model a whole tensor in ``weights``
        gives this rank its shard."""
        weights = weights or {}
        masters = []
        for n, p, place in zip(self.names, self.params, self.placements):
            w = weights.get(n)
            if w is None:
                masters.append(p.detach() if p.dtype == torch.float32
                               else p.detach().float())
                continue
            if self.axis is not None and tuple(w.shape) != tuple(p.shape):
                w = tp.local_shard(w, place, self.axis.size, self.axis.rank)
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
        # the low-precision weights the masters are rounded into; None
        # where the master is the parameter
        self._weights = [None if p.dtype == torch.float32 else p
                         for p in self.params]
        with torch.no_grad():
            self._round_weights()
        self.state = self.optimizer.init(self.masters)
        self._scalars = [torch.zeros((), dtype=torch.float32,
                                     device=self.model.device)
                         for _ in range(3)]
        # the graphs and tables read the old masters, moments and scalars
        self.graphs.clear()
        self._graph = None
        self._tables.clear()
        return self.state

    def _round_weights(self) -> None:
        """The masters, rounded, into the low-precision weights."""
        pairs = [(w, m) for w, m in zip(self._weights, self.masters)
                 if w is not None]
        if pairs:
            torch._foreach_copy_([w for w, _ in pairs],
                                 [m for _, m in pairs])

    @contextlib.contextmanager
    def training(self):
        """The model in train mode with the trainable parameters requiring
        grad; as it was afterwards.  The stage-2 loss runs the frozen VAE in
        eval mode itself; the frozen T5 trunk trains only its dropout."""
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
        terms), detached 0-dim tensors.  Under a group the returned loss and
        terms, and the gradients :meth:`apply_grads` steps with, are the
        means over the ranks (``.grad`` keeps this rank's own).  On a card
        the step replays its geometry's graphs
        (``train/step_graphs.StepGraphs.lookup``), or runs eagerly and
        counts ``train.graph_eager``."""
        if mesh.data_size() > 1 and \
                float(self.cfg.get("train", {}).get("loss", {}).get(
                    "lambda_prior", 0.0)):
            raise NotImplementedError(
                "LOSS.LAMBDA_PRIOR with data parallelism: the prior chunk "
                "splits the global batch, not a rank's")
        self._reduced = None
        self._graph = self.graphs.lookup(self, batch, generator, draws)
        if self._graph is not None:
            return self._graph.compute_grads(self, batch, draws)
        profiling.count("train.graph_eager")
        loss, terms = self.loss_and_backward(batch, generator, draws)
        if mesh.is_initialized():
            names = list(terms)
            out = mesh.all_reduce_mean(
                self._fp32([p.grad for p in self.params]) + [loss]
                + [terms[k] for k in names])
            n = len(self.params)
            self._reduced = out[:n]
            loss = out[n]
            terms = dict(zip(names, out[n + 1:]))
        return loss, terms

    def loss_and_backward(self, batch, generator, draws):
        """The loss and its backward: (loss, terms), detached."""
        with profiling.span("train.forward"):
            loss, terms = self.loss_fn()(batch, generator, draws)
        with profiling.span("train.backward"):
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    def _fp32(self, grads: Sequence[Optional[torch.Tensor]]
              ) -> List[torch.Tensor]:
        """Each gradient in fp32, zero where a parameter got none."""
        return [torch.zeros_like(m) if g is None else g.float()
                for g, m in zip(grads, self.masters)]

    def apply_grads(self):
        """One AdamW step of the masters from the gradients in fp32 (the
        ranks' mean under a group, else ``.grad``; zero where a parameter
        got none), then the rounded masters into the model's
        parameters.  Replays the optimizer graph after a graphed
        :meth:`compute_grads`."""
        graph, self._graph = self._graph, None
        with profiling.span("train.optimizer"):
            values = self.optimizer.scalars(self.state.count)
            self.state.count += 1
            for t, v in zip(self._scalars, values):
                t.fill_(v)
            if graph is not None:
                graph.apply_grads(self)
            else:
                profiling.count("train.graph_eager")
                grads = self._reduced if self._reduced is not None \
                    else [p.grad for p in self.params]
                self.optimizer_step(grads)
            self._reduced = None
            for p in self.params:
                p.grad = None
        # cached uncond encodes (CachedSampler) belong to the old weights
        self.model.weights_version += 1

    def optimizer_step(self, grads: Sequence[Optional[torch.Tensor]],
                       table: Optional[adamw.Table] = None) -> None:
        """:meth:`apply_grads`' device work from the step's gradients
        (None where a parameter got none) and the filled scalars:
        ``adamw.adamw_step``, whose work list on a card is ``table``
        (:meth:`optimizer_table`; a capture must be given it)."""
        opt = self.optimizer
        with torch.no_grad():
            norm = self._global_norm(self._fp32(grads)) \
                if self.axis is not None and opt.grad_clip else None
            if table is None:
                table = self.optimizer_table(grads)
            adamw.adamw_step(grads, self.masters, self.state.mu,
                             self.state.nu, self._weights, self._scalars,
                             opt.weight_decay, opt.grad_clip, norm, table)

    def optimizer_table(self, grads: Sequence[Optional[torch.Tensor]]
                        ) -> Optional[adamw.Table]:
        """The AdamW kernel's work list over ``grads`` and this trainer's
        masters, moments and weights; None off a card."""
        return self._tables.get(grads, self.masters, self.state.mu,
                                self.state.nu, self._weights)

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient of a placed model: the split
        tensors' squares summed over the model ranks, the replicated
        ones' (equal on every model rank) counted once."""
        split = [g for g, place in zip(grads, self.placements)
                 if not isinstance(place, tp.Replicate)]
        whole = [g for g, place in zip(grads, self.placements)
                 if isinstance(place, tp.Replicate)]

        def squares(ts):
            if not ts:
                return torch.zeros((), device=self.model.device)
            return torch.stack(torch._foreach_norm(ts)).square().sum()

        total = tp.reduce_sum(squares(split), self.axis) + squares(whole)
        return total.sqrt()

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
