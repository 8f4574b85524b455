"""A training step replayed from two CUDA graphs per input geometry.

A stage-2 step launches ~6,000 small kernels, a stage-1 step a few
thousand: the host's dispatch of them, not the card, set the pace.  A
:class:`StepGraph` holds one geometry's pair:

- the grads graph, ``Trainer.compute_grads``: the stage's loss (dropout
  masks from the registered mask generator) and its backward into the
  graph's own gradient tensors; its outputs are the detached loss, the
  terms and those gradients;
- the optimizer graph, ``Trainer.apply_grads``: one launch of the AdamW
  kernel (``ops/adamw.py``; two with a clip that computes its own norm)
  over the grads graph's gradients, reading the learning rate and both
  bias corrections from the trainer's device scalars; its work list is
  made before the capture and kept with the graph.

A geometry's first step runs eagerly on the pool's side stream (the
warm-up, and a real step); its second captures both graphs and replays
them; every later one copies the batch and draws into the graph's
buffers and replays.  The graphs read the trainable parameters, the
masters and the moments in place, so ``Trainer.init_state`` drops them.
"""
from __future__ import annotations

from typing import Optional

import torch

from convofusion_tpu_torch.parallel import mesh
from convofusion_tpu_torch.utils import cuda_graphs, profiling


class StepGraph:
    """One input geometry's grads and optimizer graphs over static copies
    of its batch and draws (module docstring)."""

    def __init__(self, pool: cuda_graphs.GraphPool, generator, batch,
                 draws):
        self._pool, self.generator = pool, generator
        self.batch = cuda_graphs.static_like(batch)
        self.draws = cuda_graphs.static_like(draws)
        self.warm = False
        self._grads = self._optimizer = self._table = None
        # the grads graph's (loss, terms, gradients)
        self.outputs = None

    def compute_grads(self, trainer, batch, draws):
        """:meth:`Trainer.compute_grads` on this geometry: (loss, terms),
        fresh tensors; the graph's gradients left as ``.grad``."""
        device = trainer.model.device
        if not self.warm:
            self.warm = True
            return self._pool.run(lambda: trainer.loss_and_backward(
                batch, self.generator, draws), device)
        cuda_graphs.copy_into(self.batch, batch)
        cuda_graphs.copy_into(self.draws, draws)
        if self._grads is None:
            def body():
                for p in trainer.params:
                    p.grad = None   # backward allocates them in the pool
                loss, terms = trainer.loss_and_backward(
                    self.batch, self.generator, self.draws)
                return loss, terms, [p.grad for p in trainer.params]

            gens = () if self.generator is None else (self.generator,)
            self._grads, self.outputs = self._pool.capture(
                body, device, warmup=False, generators=gens)
            profiling.count("train.graph_captures")
        with profiling.span("train.grads_replay"):
            self._grads.replay()
        profiling.count("train.graph_replays")
        loss, terms, grads = self.outputs
        for p, g in zip(trainer.params, grads):
            p.grad = g
        return loss.clone(), {k: v.clone() for k, v in terms.items()}

    def apply_grads(self, trainer) -> None:
        """:meth:`Trainer.apply_grads`' device work on this geometry, the
        trainer's scalars already filled."""
        device = trainer.model.device
        if self._grads is None:
            # the warm-up step's second half, after its eager grads
            self._pool.run(lambda: trainer.optimizer_step(
                [p.grad for p in trainer.params]), device)
            return
        if self._optimizer is None:
            grads = self.outputs[2]
            self._table = trainer.optimizer_table(grads)
            self._optimizer, _ = self._pool.capture(
                lambda: trainer.optimizer_step(grads, self._table), device,
                warmup=False)
            profiling.count("train.graph_captures")
        self._optimizer.replay()
        profiling.count("train.graph_replays")


class StepGraphs:
    """A trainer's :class:`StepGraph` per input geometry (the batch's and
    the draws' shapes and dtypes, the mask generator, the loss weights) in
    a ``utils/cuda_graphs.LRU``, and the one memory pool their captures
    share."""

    def __init__(self):
        self._graphs = cuda_graphs.LRU()
        self._pool = cuda_graphs.GraphPool()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()

    def lookup(self, trainer, batch, generator, draws
               ) -> Optional[StepGraph]:
        """The graph pair of this step's geometry, or None where the step
        runs eagerly: off a CUDA card, under a data-parallel group (the
        all-reduce stays eager) or a tensor-parallel placement, with
        ``remat`` (its recompute copies the mask generator's state),
        outside :meth:`Trainer.training`, with gradients still pending
        from an earlier ``compute_grads`` (eager accumulates into them), a
        mask generator on another device, or a batch or draws leaf that is
        not a tensor on the card."""
        model = trainer.model
        device = model.device
        if (device.type not in cuda_graphs.CAPTURE_DEVICES
                or mesh.is_initialized() or trainer.axis is not None
                or trainer.remat or not model.training
                or not torch.is_grad_enabled()
                or (generator is not None
                    and generator.device.type != device.type)
                or any(p.grad is not None for p in trainer.params)):
            return None
        try:
            key = (id(generator), tuple(sorted(model.loss_weights.items())),
                   cuda_graphs.geometry(batch, device),
                   cuda_graphs.geometry(draws, device))
        except cuda_graphs.Eager:
            return None
        return self._graphs.get(key, lambda: StepGraph(
            self._pool, generator, batch, draws))
