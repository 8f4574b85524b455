"""End-to-end ``sample()`` of the PyTorch port against the JAX package.

Both sides run the tiny diffusion geometry (``tiny_config('diffusion')`` /
``config.TINY``) on the same weights (JAX ``init_params(PRNGKey(0))``
carried across by ``state_dict_from_jax``), the same synthetic batch, and
the same noise: JAX's own init and per-step draws are replayed into the
port (as ``tests/test_e2e_sampler_golden.py`` replays them into the torch
reference).  Both go through the fused-step gate: the JAX kernel in
interpret mode, the port's ``guided_step`` on its plain CPU version.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion

B, STEPS = 2, 10
# fp32 on both sides.  One denoiser call agrees to ~2e-6 (GEMM summation
# order, exp/erf ulps), but the guidance combine scales each branch's
# rounding by gs * 5 = 37.5 and ten steps with x0 clipping compound it:
# the latents (|x| <= 1) differ by up to 9.2e-5 (DDPM) and 5.4e-5 (DDIM),
# the motion by 1.6e-5.  2e-4 absolute leaves 2x headroom over that.
# Without clipping the random-weight latents grow to |x| ~ 30 and the gap
# scales with them (8e-6 relative observed), hence the 2e-5 relative term.
ATOL, RTOL = 2e-4, 2e-5


def _jax_noise_sequence(key, n_steps, shape):
    """Replay diffusion_reverse's key splits (models/convofusion.py:661-665,
    751,815)."""
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, shape))
    steps = []
    for _ in range(n_steps):
        k, k_step = jax.random.split(k)
        steps.append(np.array(jax.random.normal(k_step, shape)))
    return init, np.stack(steps)


@pytest.fixture(scope="module")
def twins():
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    return params, tm, raw


@pytest.mark.parametrize("variant,clip", [("ddim", True), ("ddpm", True),
                                          ("ddim", False)])
def test_sample_matches_jax(twins, variant, clip, monkeypatch):
    """With clip_sample both sides take the fused step (JAX's kernel in
    interpret mode, the port's guided_step); without it, the plain combine
    and scheduler step."""
    params, tm, raw = twins
    cfg = tiny_config("diffusion")
    cfg.model.scheduler["variant"] = variant
    cfg.model.scheduler.params["clip_sample"] = clip
    jm = JaxConvofusion(cfg)
    tm.scheduler = dataclasses.replace(tm.scheduler, variant=variant,
                                       clip_sample=clip)
    assert tm.uses_step_kernel() == clip

    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    np.testing.assert_array_equal(tbatch["lsn_ids"].numpy(),
                                  jbatch["lsn_ids"])

    key = jax.random.PRNGKey(1)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k: jm.sample(p, b, k, num_inference_steps=STEPS))(
            params, jbatch, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, 32))

    calls, step = [], port.guided_step

    def counting_step(*args):
        calls.append(tuple(args[0].shape))
        return step(*args)

    monkeypatch.setattr(port, "guided_step", counting_step)
    motion_t, lat_t = tm.sample(tbatch, num_inference_steps=STEPS,
                                init_noise=torch.from_numpy(init),
                                step_noise=torch.from_numpy(steps))
    assert calls == [(7, B, 16, 32)] * (STEPS if clip else 0)

    assert motion_t.shape == (B, 128, 189)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j),
                               rtol=RTOL, atol=ATOL)


def test_sample_draws_only_from_an_explicit_generator(twins):
    """No global RNG: without a generator the noise must be injected, and
    one seed gives one result."""
    _, tm, raw = twins
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    with pytest.raises(ValueError, match="Generator"):
        tm.sample(tbatch, num_inference_steps=2)
    runs = [tm.sample(tbatch, torch.Generator().manual_seed(7),
                      num_inference_steps=2)[1] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
