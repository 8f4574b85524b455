"""Dropout masks from the step's generator.

JAX splits each step's dropout key off the step's key
(``convofusion_tpu/train/trainer.py:159-161``), so a run repeats from its
seed.  The port's losses scope their ``generator`` around the forward
(``ops/layers.dropout_generator``): ``fit_steps`` from one generator seed
repeats bit for bit whatever PyTorch's global generator does, and another
seed gives other losses.  The dropout-0 parity tests to JAX
(``test_torch_train.py``, ``test_torch_train_stages.py``) are unchanged.
"""
import copy

import pytest
import torch

from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops import layers
from convofusion_tpu_torch.train.trainer import Trainer

B = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tiny shapes on one intra-op thread: beside the other
    test workers, OpenMP teams as wide as the machine wait on each other,
    and these steps took ~50x longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _losses(stage, seed, steps=2):
    cfg = copy.deepcopy(TINY_VAE if stage == "vae" else TINY)
    cfg["denoiser"]["dropout"] = 0.1
    cfg["motion_vae"]["dropout"] = 0.1
    model = Convofusion(cfg, device="cpu", seed=0, stage=stage)
    raw = synthetic_raw_batch(0, B)
    batch = ({"motion": torch.from_numpy(raw["motion_lsn"])}
             if stage == "vae" else prepare_arrays(model, raw)[0])
    return Trainer(model).fit_steps([batch] * steps,
                                    torch.Generator().manual_seed(seed),
                                    log_every=1)


@pytest.mark.parametrize("stage", ["diffusion", "vae"])
def test_fit_steps_repeat_from_the_generator_seed(stage):
    torch.manual_seed(1)
    first = _losses(stage, 7)
    torch.manual_seed(2)         # PyTorch's global generator moves on
    torch.rand(100)
    assert _losses(stage, 7) == first
    assert _losses(stage, 8) != first


def test_masks_come_from_the_scoped_generator():
    drop = layers.Dropout(0.25).train()
    x = torch.ones(64, 64)
    with layers.dropout_generator(torch.Generator().manual_seed(3)):
        a = drop(x)
    with layers.dropout_generator(torch.Generator().manual_seed(3)):
        b = drop(x)
    assert torch.equal(a, b)
    # kept values are scaled by 1 / (1 - p); about 1 - p are kept
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75))}
    assert abs(float((a > 0).float().mean()) - 0.75) < 0.03
    # no generator outlives its block
    assert layers._DROPOUT_GENERATOR.get() is None


def test_eval_and_zero_rate_launch_nothing():
    x = torch.randn(4, 8)
    assert layers.Dropout(0.1).eval()(x) is x
    assert layers.Dropout(0.0).train()(x) is x


def test_dropout_gradient_is_the_mask():
    drop = layers.Dropout(0.5).train()
    x = torch.randn(32, 32, requires_grad=True)
    with layers.dropout_generator(torch.Generator().manual_seed(4)):
        y = drop(x)
    y.sum().backward()
    kept = y.detach() != 0
    assert torch.equal(x.grad, kept.float() * 2.0)
