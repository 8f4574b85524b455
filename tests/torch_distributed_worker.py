"""One rank of the port's data-parallel tests (``test_torch_distributed*``):
``python tests/torch_distributed_worker.py <scenario> <rank> <world>
<port> <out_dir> [args...]``.  Each rank joins a gloo group on localhost
through ``parallel/mesh.init_distributed`` (torchrun's environment set
here), runs the scenario on the CPU at the tiny geometry and leaves its
results in ``<out_dir>/<scenario>_rank<rank>.npz`` (or ``.json``)."""
import copy
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from convofusion_tpu_torch.config import TINY  # noqa: E402
from convofusion_tpu_torch.parallel import mesh  # noqa: E402

B = 4            # a rank's batch
STEPS = 3
# the test CLI's run: DDIM-3, WEG's refinement capped at 2
TEST_OVERRIDES = ["model.scheduler.variant=ddim",
                  "model.scheduler.num_inference_timesteps=3",
                  "model.weg_parameters.max_refinement_steps=2"]
# the rollout CLI's: 2-part recordings (3 windows), no WEG
ROLL_OVERRIDES = ["DATASET.SAMPLER.MAX_LEN=256", "DATASET.SAMPLER.MIN_LEN=256",
                  "TRAIN.ABLATION.WEG_TYPE=no"]


def tiny(dropout: float):
    """TINY with every dropout at ``dropout`` (the T5 trunk's too)."""
    cfg = copy.deepcopy(TINY)
    cfg["denoiser"]["dropout"] = dropout
    cfg["motion_vae"]["dropout"] = dropout
    cfg["audio_encoder"]["dropout"] = dropout
    cfg["text_encoder"]["dropout"] = dropout
    return cfg


def rows(tree, r: int, world: int):
    """Rank ``r``'s rows of a global batch or of global draws: 'eps' along
    axis 1, every other tensor along axis 0."""
    if isinstance(tree, dict):
        return {k: (rows(v, r, world) if isinstance(v, dict) else
                    _block(v, 1 if k == "eps" else 0, r, world))
                for k, v in tree.items()}
    return tree


def _block(x, axis, r, world):
    n = x.shape[axis] // world
    return x.narrow(axis, r * n, n)


def global_draws(model, n_steps: int, global_b: int, seed: int = 5):
    """Each step's draws for the global batch, from one host generator."""
    from convofusion_tpu_torch.cli.train import step_draws

    gen = torch.Generator().manual_seed(seed)
    return [step_draws(model, global_b, 128, gen) for _ in range(n_steps)]


def train_fed(dropout: float, r: int, world: int, global_b: int):
    """``STEPS`` Trainer steps of rank ``r`` of ``world`` on its rows of a
    global batch of ``global_b`` with the global draws fed; returns the
    reduced losses and the final weights."""
    from convofusion_tpu_torch.data.synthetic import (
        prepare_arrays,
        synthetic_raw_batch,
    )
    from convofusion_tpu_torch.models.convofusion import Convofusion
    from convofusion_tpu_torch.train.trainer import Trainer

    model = Convofusion(tiny(dropout), device="cpu", seed=0)
    batch = rows(prepare_arrays(model, synthetic_raw_batch(0, global_b))[0],
                 r, world)
    trainer = Trainer(model)
    trainer.init_state()
    losses = []
    draws = global_draws(model, STEPS, global_b)
    for step in range(STEPS):
        gen = torch.Generator().manual_seed(100 + step)
        with trainer.training():
            loss, _ = trainer.compute_grads(batch, gen,
                                            rows(draws[step], r, world))
            trainer.apply_grads()
        losses.append(float(loss))
    return np.asarray(losses), model.state_dict()


def train_drawn(r: int, world: int, global_b: int):
    """``fit_steps`` at dropout 0 with no draws fed: each rank draws the
    global batch's values from the shared generator and keeps its rows."""
    from convofusion_tpu_torch.data.synthetic import (
        prepare_arrays,
        synthetic_raw_batch,
    )
    from convofusion_tpu_torch.models.convofusion import Convofusion
    from convofusion_tpu_torch.train.trainer import Trainer

    model = Convofusion(tiny(0.0), device="cpu", seed=0)
    batch = rows(prepare_arrays(model, synthetic_raw_batch(0, global_b))[0],
                 r, world)
    losses = Trainer(model).fit_steps([batch] * 2,
                                      torch.Generator().manual_seed(9),
                                      log_every=1)
    return np.asarray(losses), model.state_dict()


def _flat(state):
    return {k: v.detach().float().numpy() for k, v in state.items()}


def scenario_trainer(r, world, out):
    results = {}
    n = world * B
    for name, fn in (("d0", lambda: train_fed(0.0, r, world, n)),
                     ("d1", lambda: train_fed(0.1, r, world, n)),
                     ("drawn", lambda: train_drawn(r, world, n))):
        losses, state = fn()
        results[f"{name}/losses"] = losses
        for k, v in _flat(state).items():
            results[f"{name}/w/{k}"] = v
    np.savez(os.path.join(out, f"trainer_rank{r}.npz"), **results)


def _patch_records(record):
    """Record the items each train batch holds and every checkpoint and
    result write of this rank."""
    from convofusion_tpu_torch.data import datamodule
    from convofusion_tpu_torch.models import results
    from convofusion_tpu_torch.train import checkpoint

    iterate = datamodule.DataLoader.__iter__

    def names_iter(self):
        for batch in iterate(self):
            if self.shuffle:
                record["items"].append([str(n) for n in batch["name"]])
            yield batch

    datamodule.DataLoader.__iter__ = names_iter
    save = checkpoint.save_checkpoint

    def counted_save(*args, **kwargs):
        record["saves"] += 1
        return save(*args, **kwargs)

    checkpoint.save_checkpoint = counted_save
    write = results.save_generation_results

    def counted_write(*args, **kwargs):
        record["result_writes"] += 1
        return write(*args, **kwargs)

    results.save_generation_results = counted_write


def _cfg_argv(root, name):
    """The experiment and assets yamls the test wrote for ``name``."""
    return ["--cfg", os.path.join(root, f"cfg_{name}.yaml"), "--cfg_assets",
            os.path.join(root, f"assets_{name}.yaml"), f"NAME={name}"]


def scenario_cli(r, world, out, root):
    """The train CLI under the group, validating each epoch: stage 1
    straight for 2 epochs, then 1 epoch and a resume to 2; then the test
    CLI and the rollout CLI (3 windows, no WEG)."""
    from convofusion_tpu_torch.cli import test as cli_test
    from convofusion_tpu_torch.cli import train as cli_train
    from convofusion_tpu_torch.cli import unbounded as cli_unbounded

    torch.set_num_threads(1)
    record = {"items": [], "saves": 0, "result_writes": 0}
    _patch_records(record)
    weights = {}
    common = ["TRAIN.BATCH_SIZE=2", "TPU.MULTIHOST=true",
              "LOGGER.SACE_CHECKPOINT_EPOCH=1", "LOGGER.VAL_EVERY_STEPS=1",
              "EVAL.BATCH_SIZE=2", "--device", "cpu"]
    for name, extra in (("straight", ["TRAIN.END_EPOCH=2"]),
                        ("resumed", ["TRAIN.END_EPOCH=1"]),
                        ("resumed", ["TRAIN.END_EPOCH=2",
                                     "TRAIN.RESUME=true"])):
        model = cli_train.main(_cfg_argv(root, f"dp_{name}") + common
                               + extra)
        record.setdefault("start_epochs", []).append(
            model.train_stats.start_epoch)
        record.setdefault("steps", []).append(
            [e["steps"] for e in model.train_stats.epochs])
        weights[name] = _flat(model.state_dict())
    run = cli_test.main(_cfg_argv(root, "dp_test") + TEST_OVERRIDES
                        + ["TPU.MULTIHOST=true", "--device", "cpu"])
    record["test_out"] = run.out_dir
    roll = cli_unbounded.main(
        _cfg_argv(root, "dp_roll") + TEST_OVERRIDES + ROLL_OVERRIDES
        + ["TPU.MULTIHOST=true", "--device", "cpu"])
    with open(os.path.join(out, f"cli_rank{r}.json"), "w") as f:
        json.dump(record, f)
    np.savez(os.path.join(out, f"cli_rank{r}.npz"),
             **{f"{n}/{k}": v for n, w in weights.items()
                for k, v in w.items()},
             **{f"roll/{i}/{j}": w for i, ws in enumerate(roll.windows)
                for j, w in enumerate(ws)})


def main(argv):
    scenario, r, world, port, out = argv[:5]
    r, world = int(r), int(world)
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    if scenario == "cli":
        # the CLIs join and leave the group themselves
        scenario_cli(r, world, out, *argv[5:])
        return
    mesh.init_distributed({"TPU": {"MULTIHOST": True}}, "cpu")
    try:
        {"trainer": scenario_trainer}[scenario](r, world, out)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
