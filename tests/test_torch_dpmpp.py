"""The port's scheduler additions and DPM-Solver++ 2M sampling against the
JAX package.

``add_noise``, ``velocity``, ``pred_original_sample`` and ``dpmpp_2m_step``
run on the same numpy inputs on both sides over a 20-step schedule.
``sample()`` with the dpmpp_2m variant runs the tiny diffusion geometry on
JAX ``init_params`` weights carried across by ``state_dict_from_jax``,
with JAX's initial noise replayed into the port (the sampler draws no step
noise), with and without a preseq to inpaint.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.diffusion.schedulers import (
    DiffusionScheduler as JaxScheduler,
)
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import PRODUCTION, TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.diffusion.schedulers import (
    DiffusionScheduler,
    scheduler_from_config,
)
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion

B, T, LAT, N_STEPS = 3, 16, 32, 20
# a few fp32 ops on values of order 1 (|x| <= 3.4) on both sides, from the
# same inputs: observed <= 3.6e-7 (3 ulps).  Without clipping a dpmpp chain
# grows to |x| ~ 9, so a relative term of the same size joins it there
# (observed 1.9e-6 at 8.75)
SCHED_TOL = 1e-6
# the port's own 20-step dpmpp chain against JAX's: the lambdas' logs differ
# by an ulp at two steps and the steps carry it; observed 1.6e-6
CHAIN_TOL = 1e-5
# sample(): tests/test_torch_sampler.py's fp32 tolerance (one denoiser call
# agrees to ~2e-6, the guidance combine scales it by gs * 5 = 37.5 and the
# steps compound it); observed dpmpp-10 latents 4.1e-5 / 5.6e-5 and motion
# 1.3e-5 / 1.4e-5 without / with a preseq
ATOL, RTOL = 2e-4, 2e-5
STEPS = 10


def _both(clip=True):
    return (JaxScheduler(clip_sample=clip, variant="dpmpp_2m"),
            DiffusionScheduler(clip_sample=clip, variant="dpmpp_2m"))


def test_noise_scheduler_is_the_training_ddpm():
    """config.noise_scheduler is scheduler.yaml:13-21, DDPM with eta 0
    (no variant or eta given), the table the rollout re-noises with."""
    s = scheduler_from_config(PRODUCTION["noise_scheduler"])
    assert (s.variant, s.eta, s.clip_sample) == ("ddpm", 0.0, True)
    np.testing.assert_array_equal(s.alphas_cumprod,
                                  JaxScheduler().alphas_cumprod)
    assert PRODUCTION["fps"] == TINY["fps"] == 25


@pytest.mark.parametrize("fn", ["add_noise", "velocity"])
@pytest.mark.parametrize("step", [0, N_STEPS // 2, N_STEPS - 1],
                         ids=["first", "middle", "final"])
def test_add_noise_and_velocity_match_jax(fn, step):
    """At a 20-step schedule's timestep, given as a (B,) array with one
    row at another step and as a Python int."""
    js, ts = JaxScheduler(), DiffusionScheduler()
    t = int(ts.timesteps(N_STEPS)[step])
    rng = np.random.default_rng(step)
    x, z = (rng.standard_normal((B, T, LAT)).astype(np.float32)
            for _ in range(2))
    tb = np.asarray([t, t, int(ts.timesteps(N_STEPS)[0])], np.int32)
    want = np.asarray(getattr(js, fn)(jnp.asarray(x), jnp.asarray(z),
                                      jnp.asarray(tb)))
    got = getattr(ts, fn)(torch.from_numpy(x), torch.from_numpy(z),
                          torch.from_numpy(tb))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCHED_TOL)
    scalar = getattr(ts, fn)(torch.from_numpy(x), torch.from_numpy(z), t)
    np.testing.assert_allclose(scalar.numpy()[:2], want[:2], rtol=0,
                               atol=SCHED_TOL)


@pytest.mark.parametrize("clip", [True, False])
def test_dpmpp_2m_chain_matches_jax(clip):
    """A 20-step chain on seeded model outputs.  Every step, from the first
    (first order) through the second-order ones carrying prev_d and the
    lambda to the final one (x0 exactly), is held to JAX's from JAX's own
    carry within SCHED_TOL; the port's own chain ends within CHAIN_TOL."""
    js, ts = _both(clip)
    times, prevs = ts.timesteps(N_STEPS), ts.prev_timesteps(N_STEPS)
    rng = np.random.default_rng(7)
    sample = rng.standard_normal((B, T, LAT)).astype(np.float32)
    outs = rng.standard_normal((N_STEPS, B, T, LAT)).astype(np.float32)
    j = (jnp.asarray(sample), jnp.zeros((B, T, LAT)), jnp.float32(0.0))
    p = (torch.from_numpy(sample), torch.zeros(B, T, LAT), 0.0)
    for i in range(N_STEPS):
        t, pt = int(times[i]), int(prevs[i])
        jo = js.dpmpp_2m_step(jnp.asarray(outs[i]), t, pt, j[0], j[1],
                              j[2], i == 0)
        same = ts.dpmpp_2m_step(
            torch.from_numpy(outs[i]), t, pt,
            torch.from_numpy(np.array(j[0])),
            torch.from_numpy(np.array(j[1])), float(j[2]), i == 0)
        for got, want in zip(same[:3], jo[:3]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0 if clip else SCHED_TOL,
                                       atol=SCHED_TOL, err_msg=i)
        assert same[3].dtype == torch.float32 and same[3].ndim == 0
        assert abs(float(same[3]) - float(jo[3])) <= SCHED_TOL * max(
            1.0, abs(float(jo[3])))
        po = ts.dpmpp_2m_step(torch.from_numpy(outs[i]), t, pt, p[0], p[1],
                              p[2], i == 0)
        j, p = (jo[0], jo[2], jo[3]), (po[0], po[2], po[3])
    # the final step (prev_t < 0) returns x0 itself
    assert prevs[-1] < 0 and torch.equal(po[0], po[1])
    np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]),
                               rtol=0 if clip else CHAIN_TOL, atol=CHAIN_TOL)


def test_pred_original_sample_matches_jax():
    js, ts = JaxScheduler(), DiffusionScheduler()
    rng = np.random.default_rng(9)
    x, eps = (rng.standard_normal((B, T, LAT)).astype(np.float32)
              for _ in range(2))
    for t in (0, 499, 999):
        want = np.asarray(js.pred_original_sample(jnp.asarray(eps), t,
                                                  jnp.asarray(x)))
        got = ts.pred_original_sample(torch.from_numpy(eps), t,
                                      torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SCHED_TOL)


# ------------------------------------------------------------ model level
@pytest.fixture(scope="module")
def twins():
    cfg = tiny_config("diffusion")
    cfg.model.scheduler["variant"] = "dpmpp_2m"
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    tm.scheduler = dataclasses.replace(tm.scheduler, variant="dpmpp_2m")
    raw = jax_synthetic.synthetic_raw_batch(3, 2)
    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    return jm, params, tm, jbatch, tbatch


@pytest.mark.parametrize("with_preseq", [False, True],
                         ids=["plain", "preseq"])
def test_dpmpp_sample_matches_jax(twins, with_preseq, monkeypatch):
    """dpmpp_2m sample(): JAX's initial noise replayed, no step noise
    drawn (no generator is given, so a draw would raise), and the fused
    step kernel never called, as JAX's gate says."""
    jm, params, tm, jbatch, tbatch = twins
    assert not tm.uses_step_kernel()
    preseq = (np.random.default_rng(5).standard_normal(
        (2, 8, LAT)).astype(np.float32) * 0.3 if with_preseq else None)
    key = jax.random.PRNGKey(3)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k, ps: jm.sample(p, b, k, num_inference_steps=STEPS,
                                      preseq=ps))(
        params, jbatch, key, None if preseq is None else jnp.asarray(preseq))
    k_init, _ = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, (2, T, LAT)))

    calls = []
    monkeypatch.setattr(port, "guided_step",
                        lambda *a: calls.append(a) or None)
    motion_t, lat_t = tm.sample(
        tbatch, num_inference_steps=STEPS, init_noise=torch.from_numpy(init),
        preseq=None if preseq is None else torch.from_numpy(preseq))
    assert calls == []
    assert motion_t.shape == (2, 128, 189)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j),
                               rtol=RTOL, atol=ATOL)
