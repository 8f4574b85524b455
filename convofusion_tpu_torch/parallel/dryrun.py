"""One sharded training step at the tiny geometry: pure data parallelism,
then dp x tp.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:88-149``), with
its two phases and its printed lines:

1. dp: ``create_mesh(n, 1)``, the batch split over 'data', the parameters
   replicated, one Trainer step (loss, gradients, the all-reduce, AdamW);
2. dp x tp, when the world is even: ``create_mesh(n / 2, 2)``, the model
   placed by the tensor-parallel rules (``parallel/tp.py``), one step.

Run it under torchrun, one process a card (NCCL), or with ``--device cpu``
(gloo)::

    torchrun --nproc_per_node=2 -m convofusion_tpu_torch.parallel.dryrun
    torchrun --nproc_per_node=2 -m convofusion_tpu_torch.parallel.dryrun \\
        --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from convofusion_tpu_torch.parallel import mesh

BATCH = 8           # the global batch, __graft_entry__.py:71


def _tiny_model(device):
    """The tiny stage-2 model from seed 0 and the global batch of 8
    (``__graft_entry__.py:58-72``)."""
    from convofusion_tpu_torch.config import TINY
    from convofusion_tpu_torch.data.synthetic import (
        prepare_arrays,
        synthetic_raw_batch,
    )
    from convofusion_tpu_torch.models.convofusion import Convofusion

    model = Convofusion(TINY, device=device, seed=0)
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, BATCH))
    return model, batch


def _step(layout, device):
    """One Trainer step of a fresh model on ``layout``, each data rank on
    its rows of the global batch; the loss averaged over the data ranks."""
    from convofusion_tpu_torch.train.trainer import Trainer

    model, batch = _tiny_model(device)
    trainer = Trainer(model, mesh=layout)
    rows = {k: mesh.local_rows(v) if torch.is_tensor(v) else v
            for k, v in batch.items()}
    gen = torch.Generator(device=model.device).manual_seed(1)
    loss, _ = trainer.train_step(rows, gen)
    return model, float(loss)


def dryrun(device=None) -> Dict:
    """Both phases on the live group; returns their losses and the
    dp x tp placement counts (None on an odd world)."""
    n = mesh.world_size()
    out: Dict = {"world": n}
    _, out["dp_loss"] = _step(mesh.create_mesh(n, 1, device), device)
    if mesh.is_main():
        print(f"dryrun_multichip({n}) dp: loss={out['dp_loss']:.4f}")
    out["tp_loss"] = out["tp_counts"] = None
    if n % 2 == 0:
        from convofusion_tpu_torch.parallel.tp import describe_tp

        layout = mesh.create_mesh(n // 2, 2, device)
        model, out["tp_loss"] = _step(layout, device)
        counts = out["tp_counts"] = describe_tp(model, layout)
        if mesh.is_main():
            print(f"dryrun_multichip({n}) dp x tp ({n // 2}x2, "
                  f"{counts['sharded']} sharded / {counts['replicated']} "
                  f"replicated params): loss={out['tp_loss']:.4f}")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the host; default the card")
    args = ap.parse_args(argv)
    device: Optional[torch.device] = mesh.init_distributed(
        {"TPU": {"MULTIHOST": True}}, args.device)
    try:
        return dryrun(device)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
