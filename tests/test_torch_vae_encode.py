"""VAE encode of the PyTorch port against JAX ``vae_encode`` at the tiny
geometry, fp32, on JAX ``init_params`` weights: the posterior mean, the
reparameterised sample with JAX's own ``jax.random.normal(sample_key, ...)``
fed as ``eps``, and the batch-leading posterior of the cached-posterior
layout."""
import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data.synthetic import synthetic_motion
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.models.convofusion import Convofusion

# fp32: two 3-layer skip encoders over 18 tokens, outputs of O(1)
ATOL = 1e-5
B = 3


@pytest.fixture(scope="module")
def twins():
    jm = JaxConvofusion(tiny_config("vae"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    assert set(params) == {"vae"}
    tm = Convofusion(TINY_VAE, device="cpu", seed=None, stage="vae")
    tm.load_state_dict(state_dict_from_jax(params))
    # root positions far from 0, so the per-chunk root normalisation shows
    motion = synthetic_motion(np.random.default_rng(4), B) + np.float32(2.5)
    return jm, params, tm, motion


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("sampled", [False, True], ids=["mean", "sample"])
def test_encode_matches_jax(twins, sampled):
    """latent, mu, logvar and the chunk-normalised features."""
    jm, params, tm, motion = twins
    key = jax.random.PRNGKey(7) if sampled else None
    want = jm.vae_encode(params, motion, sample_key=key)
    eps = None
    if sampled:
        eps = torch.from_numpy(np.array(jax.random.normal(
            key, want[1][0].shape)))
    with torch.no_grad():
        got = tm.vae.encode(torch.from_numpy(motion), eps=eps)
    (lat_w, (mu_w, lv_w), feat_w), (lat_g, (mu_g, lv_g), feat_g) = want, got
    assert lat_g.shape == (2, B, 8, 32)
    for g, w in ((lat_g, lat_w), (mu_g, mu_w), (lv_g, lv_w),
                 (feat_g, feat_w)):
        _close(g, w)
    # each chunk's first frame has root x = z = 0, y untouched
    chunks = feat_g.reshape(B, 8, 16, -1)
    assert float(chunks[:, :, 0, [0, 2]].abs().max()) == 0.0
    assert not torch.equal(lat_g, mu_g) if sampled else torch.equal(lat_g,
                                                                      mu_g)


def test_encode_vae_posterior_matches_jax():
    """The frozen VAE's posterior for the cached layout: (B, 2, 8, D) each,
    from the stage-2 model in train mode (it encodes in eval mode)."""
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(2)))
    cfg = dict(TINY, motion_vae={**TINY["motion_vae"], "dropout": 0.5})
    tm = Convofusion(cfg, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    tm.train()
    motion = synthetic_motion(np.random.default_rng(5), B)
    want = jm.encode_vae_posterior(params, motion)
    got = tm.encode_vae_posterior(torch.from_numpy(motion))
    assert tm.vae.training
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, 2, 8, 32) and not g.requires_grad
        _close(g, w)


def test_motion_token_init_is_standard_normal():
    """The global motion tokens get N(0, 1) from the seeded init, as flax's
    ``normal(1.0)``, and stay fp32 in a bf16 model."""
    tm = Convofusion(TINY_VAE, dtype="bfloat16", device="cpu", seed=3,
                     stage="vae")
    for part in ("body", "hands"):
        tok = getattr(tm.vae, f"{part}_global_motion_token")
        assert tok.dtype == torch.float32 and tuple(tok.shape) == (2, 32)
        assert 0.5 < float(tok.std()) < 1.5
