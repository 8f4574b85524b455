"""The T5 trunk's dropout (``model.text_encoder.params.dropout``) against
JAX's, with JAX's masks fed to the port.

JAX applies the rate at six sites of its trunk
(``convofusion_tpu/models/t5.py:96-97,123,129,132,151,160``) whenever the
conditions are encoded with ``deterministic=False``: in the stage-2 loss.
Here every active ``nn.Dropout`` of the JAX side is intercepted
(``flax.linen.intercept_methods``) and given a numpy-drawn keep mask, and
the port's ``ops/layers.Dropout`` takes the same masks in the same order.

- The T5 stack in train mode at the tiny width: within 1e-5 of JAX's.
- The stage-2 loss, its terms and every gradient at T5 dropout 0.1 (the
  other dropouts at 0): ``test_torch_train``'s bounds.
- The trunk stays frozen: no gradient, weights bit-identical after steps;
  ``from_cfg`` and ``Convofusion`` build the rate into every site.
- The train CLI turns the trunk cache off at a nonzero rate (JAX
  ``cli/train.py:128-131``), and a resume at rate 0.1 is bit-equal to the
  straight run on the CPU.
"""
import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.t5 import T5EncoderStack as JaxT5Stack
from convofusion_tpu.models.t5 import t5_params_from_torch
from convofusion_tpu_torch.cli import train as cli_train
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.t5 import T5EncoderModel
from convofusion_tpu_torch.ops import layers
from convofusion_tpu_torch.train.trainer import Trainer
from test_torch_test_cli import _write_cfg
from test_torch_train import (
    B,
    assert_match,
    diffusion_draws,
    jax_model,
    jax_params_from_port,
    jax_value_and_grad,
    port_config,
    port_value_and_grad,
)

RATE = 0.1
STACK_ATOL = 1e-5
T5 = {k: TINY["text_encoder"][k] for k in (
    "vocab_size", "d_model", "d_ff", "num_layers", "num_heads", "d_kv")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_masks(record, seed=0):
    """While open, every active flax ``nn.Dropout`` draws its keep mask
    from a numpy generator (seeded ``seed``) instead of its key, applies
    it as flax does, and appends it to ``record``."""
    rng = np.random.default_rng(seed)

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or \
                context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        det = fnn.merge_param("deterministic", mod.deterministic, det)
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        mask = rng.random(x.shape) < keep
        record.append(mask)
        return jax.lax.select(jnp.asarray(mask), x / keep,
                              jnp.zeros_like(x))

    return fnn.intercept_methods(interceptor)


@pytest.fixture
def fed_masks(monkeypatch):
    """The port's training Dropouts take their masks, in order, from the
    list this returns."""
    masks = []

    def forward(self, x):
        if self.training and self.p > 0.0:
            m = torch.from_numpy(masks.pop(0)).to(x.dtype)
            return (x * m).mul_(1.0 / (1.0 - self.p))
        return x

    monkeypatch.setattr(layers.Dropout, "forward", forward)
    return masks


def test_stack_in_train_mode_matches_jax(fed_masks):
    torch.manual_seed(0)
    port = T5EncoderModel(dropout=RATE, **T5)
    layers.init_weights(port, torch.Generator().manual_seed(1))
    params = t5_params_from_torch(
        {k: v.numpy() for k, v in port.state_dict().items()},
        T5["num_layers"])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, T5["vocab_size"], (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = mask[2, 5:] = False
    record = []
    with jax_masks(record):
        want = JaxT5Stack(dropout=RATE, **T5).apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    # the embedding, 4 sites a block, the output
    assert len(record) == 2 + 4 * T5["num_layers"]
    fed_masks.extend(record)
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert not fed_masks
    gap = np.abs(got.numpy() - np.asarray(want)).max()
    assert gap <= STACK_ATOL, gap
    # eval mode: no site draws, and the stack is JAX's deterministic one
    port.eval()
    with torch.no_grad():
        det = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    want_det = JaxT5Stack(dropout=RATE, **T5).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    assert np.abs(det.numpy() - np.asarray(want_det)).max() <= STACK_ATOL


def test_stage2_loss_and_grads_match_jax_with_masks_fed(fed_masks):
    cfg = port_config()
    cfg["text_encoder"]["dropout"] = RATE
    pm = Convofusion(cfg, device="cpu", seed=0)
    params = jax_params_from_port(pm)
    jm = jax_model()
    jm.text_encoder = jm.text_encoder.clone(dropout=RATE)
    raw = jax_synthetic.synthetic_raw_batch(1, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    key = jax.random.PRNGKey(3)
    record = []
    with jax_masks(record, seed=4):
        want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb,
                                  key)
    # the speaker's and the listener's trunk, each 2 + 4 L sites
    assert len(record) == 2 * (2 + 4 * cfg["text_encoder"]["num_layers"])
    fed_masks.extend(record)
    got = port_value_and_grad(pm, tb, diffusion_draws(jm, key, B))
    assert not fed_masks
    assert_match(pm, got, want)
    # without the masks the rate matters: the loss moves
    fed_masks.clear()
    plain = jax_value_and_grad(jax_model(), "train_diffusion_loss", params,
                               jb, key)
    assert plain[0] != want[0]


def test_rate_is_built_and_the_trunk_stays_frozen():
    cfg = copy.deepcopy(TINY)
    cfg["text_encoder"]["dropout"] = RATE
    cfg["audio_encoder"]["dropout"] = 0.0
    model = Convofusion(cfg, device="cpu", seed=0)
    trunk = model.text_encoder.text_model
    sites = [m for m in trunk.modules() if isinstance(m, layers.Dropout)]
    assert len(sites) == 1 + 4 * cfg["text_encoder"]["num_layers"]
    assert all(m.p == RATE for m in sites)
    assert model.text_encoder.dropout == RATE
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    batch, _, _ = torch_synthetic.prepare_arrays(
        model, torch_synthetic.synthetic_raw_batch(0, 4))
    gen = torch.Generator().manual_seed(5)
    trainer = Trainer(model)
    trainer.init_state()
    with trainer.training():
        assert trunk.training
        trainer.compute_grads(batch, gen)
        assert all(p.grad is None for p in trunk.parameters())
        trainer.apply_grads()
    losses = Trainer(model).fit_steps([batch] * 2, gen, log_every=1)
    assert all(np.isfinite(losses))
    for k, v in trunk.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the cached layout encodes the trunk without its dropout
    model.train()
    a = model.encode_text_trunk(batch["lsn_ids"], batch["lsn_tmask"])
    b = model.encode_text_trunk(batch["lsn_ids"], batch["lsn_tmask"])
    assert torch.equal(a, b) and trunk.training


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("t5_dropout_cli"))
    beat, dnd = make_fixture_pair(root, n_files=1)
    for name in ("straight", "resumed"):
        _write_cfg(root, beat, dnd, "diffusion", name)
    return root


def _cli(root, name, *extra):
    return cli_train.main([
        "--cfg", os.path.join(root, f"cfg_{name}.yaml"), "--cfg_assets",
        os.path.join(root, f"assets_{name}.yaml"), f"NAME={name}",
        f"model.text_encoder.params.dropout={RATE}", "TRAIN.BATCH_SIZE=4",
        "LOGGER.SACE_CHECKPOINT_EPOCH=1", "--device", "cpu", *extra])


def test_cli_turns_the_trunk_cache_off_and_resumes_bit_equal(tree):
    straight = _cli(tree, "straight", "TRAIN.END_EPOCH=2")
    assert straight.text_encoder.dropout == RATE
    assert not cli_train.uses_trunk_cache(straight, {})
    assert all("trunk_hits" not in e for e in straight.train_stats.epochs)
    assert all("posterior_hits" in e for e in straight.train_stats.epochs)
    _cli(tree, "resumed", "TRAIN.END_EPOCH=1")
    resumed = _cli(tree, "resumed", "TRAIN.END_EPOCH=2", "TRAIN.RESUME=true")
    assert resumed.train_stats.start_epoch == 1
    want = straight.state_dict()
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k
    rate0 = copy.deepcopy(TINY)
    assert cli_train.uses_trunk_cache(Convofusion(rate0, device="cpu"), {})
