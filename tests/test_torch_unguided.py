"""Unguided sampling (``guidance_scale`` <= 1) of the PyTorch port against
the JAX package.

Both sides run the tiny diffusion geometry at guidance scale 1.0 on the
same weights (JAX ``init_params(PRNGKey(0))`` through
``state_dict_from_jax``), the same synthetic batch and JAX's own noise
replayed into the port.  A step is one denoiser call on the real
conditions and the plain scheduler update on both sides (JAX
``models/convofusion.py:651-655,837-839``); the fused step kernel is never
called, as JAX's gate ``use_pallas = use_guided and ...`` says.
"""
import copy
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
from test_torch_sampler import ATOL, RTOL, _jax_noise_sequence

B, STEPS, LAT = 2, 6, 32
# attention maps are softmax rows of fp32 denoiser layers (as in
# tests/test_torch_test_cli.py); without the x37.5 guidance amplification
# the latents agree far closer than the guided ones
ATT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    cfg = tiny_config("diffusion")
    cfg.model.guidance_scale = 1.0
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tcfg = copy.deepcopy(TINY)
    tcfg["guidance_scale"] = 1.0
    tm = Convofusion(tcfg, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    return params, tm, raw


@pytest.mark.parametrize("variant", ["ddim", "ddpm", "dpmpp_2m"])
def test_unguided_sample_matches_jax(twins, variant, monkeypatch):
    """Motion, latents and the full-condition attention maps of every step
    against JAX's ``sample(..., capture_attention='all')``; 0 calls of the
    step kernel."""
    params, tm, raw = twins
    cfg = tiny_config("diffusion")
    cfg.model.guidance_scale = 1.0
    cfg.model.scheduler["variant"] = variant
    jm = JaxConvofusion(cfg)
    assert not jm.do_classifier_free_guidance
    tm.scheduler = dataclasses.replace(tm.scheduler, variant=variant)
    assert not tm.do_classifier_free_guidance and not tm.uses_step_kernel()

    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    key = jax.random.PRNGKey(4)
    motion_j, lat_j, att_j = jax.jit(lambda p, b, k: jm.sample(
        p, b, k, num_inference_steps=STEPS, capture_attention="all"))(
        params, jbatch, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, LAT))
    noise = {"init_noise": torch.from_numpy(init)}
    if variant != "dpmpp_2m":
        noise["step_noise"] = torch.from_numpy(steps)

    calls = []
    monkeypatch.setattr(port, "guided_step",
                        lambda *a: calls.append(a) or None)
    motion_t, lat_t, att_t = tm.sample(tbatch, num_inference_steps=STEPS,
                                       capture_attention="all", **noise)
    assert calls == []
    assert motion_t.shape == (B, 128, 189) and lat_t.shape == (B, 16, LAT)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j),
                               rtol=RTOL, atol=ATOL)
    assert set(att_t) == set(att_j)
    for s, want in att_j.items():
        want = np.asarray(want)
        assert tuple(att_t[s].shape) == want.shape, s
        assert want.shape[:3] == (STEPS, B, 3), s
        np.testing.assert_allclose(att_t[s].numpy(), want, atol=ATT_ATOL,
                                   rtol=0, err_msg=s)


def test_unguided_cached_sampler_and_preseq(twins, monkeypatch):
    """The cached sampler (the rollout's and the service's entry) takes
    the unguided path too, preseq inpainting included: the same latents
    as ``sample()`` and no kernel call."""
    _, tm, raw = twins
    tm.scheduler = dataclasses.replace(tm.scheduler, variant="ddim")
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    rng = np.random.default_rng(8)
    init = torch.from_numpy(rng.standard_normal((B, 16, LAT)).astype(
        np.float32))
    steps = torch.from_numpy(rng.standard_normal((STEPS, B, 16, LAT)).astype(
        np.float32))
    preseq = torch.from_numpy(rng.standard_normal((B, 8, LAT)).astype(
        np.float32) * 0.3)
    calls = []
    monkeypatch.setattr(port, "guided_step",
                        lambda *a: calls.append(a) or None)
    _, direct = tm.sample(tbatch, num_inference_steps=STEPS, init_noise=init,
                          step_noise=steps, preseq=preseq)
    _, cached = tm.cached_sampler(STEPS)(tbatch, init_noise=init,
                                         step_noise=steps, preseq=preseq)
    assert calls == []
    assert torch.equal(direct, cached) and torch.isfinite(direct).all()
