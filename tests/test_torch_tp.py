"""Tensor parallelism (``parallel/tp.py``, the Trainer's ``mesh``,
``parallel/dryrun.py``) against JAX's rules and one process.

- Placement, no processes: JAX's ``tp_shardings`` over the parameter shapes
  (``jax.eval_shape``, nothing compiles) on a (4, 2) mesh of the 8 virtual
  CPU devices.  Every element JAX puts on model index r is, through
  ``compat/from_jax``'s names and transposes, an element the port's model
  rank r holds, in its order, and no other: the packed q/k/v thirds
  included, at the tiny geometry, with fused streams, and at the
  production widths (depth cut to one layer a stack: the rules depend on
  widths alone).  ``describe_tp``'s split element total equals JAX's.
- Two gloo ranks, a (1, 2) mesh: 3 steps without the clip, with a clip
  that bites and at dropout 0.1 (the masks, drawn at the whole
  activation's shape, are one process's), against one process on the same
  weights, batch and draws: losses within 1e-6 relative, step 1's
  gradients and the final weights within 1e-6 (where step 1's gradient is
  within 1e-6 of zero, the weight within AdamW's +-lr bound a step).
- ``parallel/dryrun.py`` under 2 ranks prints both phases' lines.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

from convofusion_tpu.config import DEFAULTS_DIR as JAX_DEFAULTS
from convofusion_tpu.config import load_config as jax_load_config
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.parallel.mesh import create_mesh as jax_create_mesh
from convofusion_tpu.parallel.tp import tp_shardings
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.parallel import mesh, tp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_distributed_worker as worker  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    LOSS_RTOL,
    WEIGHT_ATOL,
    run_ranks,
)

GRAD_ATOL = 1e-6
N_DATA, N_MODEL = 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """The (4, 2) mesh's shape, for ``describe_tp`` without a group."""

    def size(self, dim):
        return (N_DATA, N_MODEL)[dim]


def _jax_cfg(kind):
    if kind == "production":
        cfg = jax_load_config(os.path.join(JAX_DEFAULTS,
                                           "config_cf_beatdnd.yaml"))
        cfg.DATASET.NFEATS, cfg.DATASET.NJOINTS = 189, 63
        cfg.model.denoiser.params.num_layers = 1
        cfg.model.motion_vae.params.num_layers = 1
        cfg.model.text_encoder.params.num_layers = 1
        return cfg
    cfg = tiny_config("diffusion")
    cfg.model.denoiser.params.fuse_streams = kind == "fused"
    return cfg


def owner_state_dict(kind):
    """The port state dict whose every element holds the JAX model index
    that owns it (1 or 2) under ``tp_shardings``, 0 where JAX replicates
    the leaf; and JAX's split element total."""
    model = JaxConvofusion(_jax_cfg(kind))
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    layout = jax_create_mesh(N_DATA, N_MODEL)
    shardings = tp_shardings(shapes, layout)
    split = [0]

    def owner(leaf, sharding):
        out = np.zeros(leaf.shape, np.float32)
        if all(a is None for a in sharding.spec):
            return out
        split[0] += out.size
        index = sharding.devices_indices_map(leaf.shape)
        for m in range(N_MODEL):
            out[index[layout.devices[0, m]]] = m + 1
        return out

    tree = jax.tree_util.tree_map(owner, shapes, shardings)
    return state_dict_from_jax(tree), split[0]


@pytest.mark.parametrize("kind", ["tiny", "fused", "production"])
def test_each_model_rank_holds_the_elements_jax_gives_it(kind):
    owners, jax_split = owner_state_dict(kind)
    split = 0
    for name, owner in owners.items():
        owner = owner.numpy()
        placement = tp.placement_for(name, owner.shape, N_MODEL)
        ids = torch.arange(owner.size).reshape(owner.shape)
        for r in range(N_MODEL):
            want = np.flatnonzero((owner == r + 1) | (owner == 0))
            got = tp.local_shard(ids, placement, N_MODEL, r).numpy().ravel()
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")
        if not isinstance(placement, Replicate):
            split += owner.size
    assert split == jax_split
    if kind == "tiny":
        packed = [n for n in owners if n.endswith("in_proj_weight")]
        assert packed and all(isinstance(tp.placement_for(
            n, owners[n].shape, N_MODEL), tp.Packed) for n in packed)
        counts = tp.describe_tp(Convofusion(TINY, device="cpu", seed=0),
                                _Mesh())
        assert counts["sharded_elements"] == jax_split
        assert counts["sharded"] + counts["replicated"] == len(owners)


def test_a_split_that_does_not_divide_stays_replicated():
    """JAX skips a spec whose axis does not divide the leaf
    (``convofusion_tpu/parallel/tp.py:48-59``)."""
    assert tp.placement_for("a.linear1.weight", (64, 32), 2) == tp.Shard(0)
    assert tp.placement_for("a.linear1.weight", (64, 32), 3) == Replicate()
    assert tp.placement_for("a.in_proj_bias", (96,), 2) == tp.Packed(0, 3)
    assert tp.placement_for("a.in_proj_bias", (96,), 64) == Replicate()
    assert tp.placement_for("a.linear2.bias", (32,), 2) == Replicate()
    assert tp.placement_for("a.norm1.weight", (32,), 2) == Replicate()


def test_create_mesh_needs_a_group():
    assert not mesh.is_initialized()
    with pytest.raises(RuntimeError, match="live torch.distributed group"):
        mesh.create_mesh(1, 1)
    assert (mesh.data_rank(), mesh.data_size(), mesh.data_group()) == \
        (0, 1, None)


def _check_against_one_process(npz, name, losses, grads, weights):
    """Losses within 1e-6 relative, step 1's gradients within 1e-6, and the
    final weights within 1e-6, except where step 1's gradient is within its
    own tolerance of zero: AdamW's m / sqrt(v) turns the rounding of such a
    gradient (the key biases' are 0 in exact arithmetic) into a step of up
    to lr, so those elements are held to that bound."""
    np.testing.assert_allclose(npz[f"{name}/losses"], losses,
                               rtol=LOSS_RTOL, atol=0)
    for k, v in grads.items():
        gap = np.abs(npz[f"{name}/g/{k}"] - v).max()
        assert gap <= GRAD_ATOL, (name, k, gap)
    lr = worker.TINY["train"]["optim"]["lr"]
    for k, v in weights.items():
        gap = np.abs(npz[f"{name}/w/{k}"] - v)
        unresolved = np.abs(grads[k]) <= GRAD_ATOL if k in grads \
            else np.zeros(v.shape, bool)
        assert gap[~unresolved].max(initial=0) <= WEIGHT_ATOL, (name, k)
        assert gap[unresolved].max(initial=0) <= 2 * lr * worker.STEPS, \
            (name, k)


def check_tp_run(tmp_path, world, n_data, stage):
    """``world`` ranks of the ``tp`` scenario on an (n_data, world / n_data)
    mesh against one process on the global batch."""
    run_ranks("tp", tmp_path, n_data, stage, world=world)
    ranks = [np.load(tmp_path / f"tp_rank{r}.npz") for r in range(world)]
    for name, cfg in worker.tp_cases(stage, n_data).items():
        losses, grads, weights = worker.train_tp(stage, cfg, 1, 1,
                                                 n_data * worker.B)
        if name == "clip":       # the clip bites: the step-1 norm is above
            norm = np.sqrt(sum(float((g ** 2).sum())
                               for g in grads.values()))
            assert norm > 2 * worker.CLIP, norm
        for npz in ranks:
            _check_against_one_process(npz, name, losses, grads, weights)


def test_two_model_ranks_equal_one_process(tmp_path):
    check_tp_run(tmp_path, 2, 1, "diffusion")


def test_dryrun_prints_both_phases_under_two_ranks(tmp_path):
    import json

    logs = run_ranks("dryrun", tmp_path)
    assert "dryrun_multichip(2) dp: loss=" in logs[0]
    assert "dryrun_multichip(2) dp x tp (1x2, " in logs[0]
    assert "dryrun_multichip" not in logs[1]      # rank 0 prints
    results = [json.load(open(tmp_path / f"dryrun_rank{r}.json"))
               for r in range(2)]
    assert results[0] == results[1]
    res = results[0]
    assert np.isfinite([res["dp_loss"], res["tp_loss"]]).all()
    assert res["tp_counts"]["sharded"] > 0
    assert "cannot form a (3, 1) mesh" in res["bad_mesh"]
