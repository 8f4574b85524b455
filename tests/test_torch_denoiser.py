"""The port's ``Denoiser.guided`` and ``Denoiser.__call__`` against the JAX
package at the tiny geometry, fp32, on JAX ``init_params`` weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops.transformer import COND_STREAMS

B, T, LAT, D = 3, 16, 32, 64
LENGTHS = {"spkemb": 16, "alsn": 161, "tlsn": 16, "apb": 8, "lsnemb": 1}
# fp32 on both sides; differences are GEMM summation order and exp/erf
# ulps through 3 layers: noise_pred (|x| <= 3.6) differs by ~2.3e-6, the
# attention weights by ~4e-7
ATOL = 2e-5


@pytest.fixture(scope="module")
def twins():
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def _conditions(rng, batch):
    return {s: rng.standard_normal((batch, n, D)).astype(np.float32)
            for s, n in LENGTHS.items()}


def _masks(batch, valid):
    """Pad masks (True = pad) for the two text streams."""
    out = {}
    for s in ("spkemb", "tlsn"):
        m = np.zeros((batch, LENGTHS[s]), bool)
        for i, v in enumerate(valid[:batch]):
            m[i, v:] = True
        out[s] = m
    return out


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_guided_matches_jax(twins):
    """7-branch noise_pred (7, B, 16, D) and the full-condition attention,
    with single-row (encode_uncond-shaped) uncond conditions."""
    jm, params, tm = twins
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((B, T, LAT)).astype(np.float32)
    cond_real, cond_unc = _conditions(rng, B), _conditions(rng, 1)
    masks_real, masks_unc = _masks(B, [16, 9, 4]), _masks(1, [3])
    t = 620

    np_j, att_j = jm.denoiser.apply(
        {"params": params["denoiser"]}, jnp.asarray(sample), jnp.asarray(t),
        cond_real, cond_unc, masks_real, masks_unc,
        method=jm.denoiser.guided)
    with torch.no_grad():
        np_t, att_t = tm.denoiser.guided(
            torch.from_numpy(sample), t, _t(cond_real), _t(cond_unc),
            _t(masks_real), _t(masks_unc))
    assert np_t.shape == (7, B, T, LAT)
    np.testing.assert_allclose(np_t.numpy(), np.asarray(np_j),
                               rtol=0, atol=ATOL)
    for s in COND_STREAMS:
        assert att_t[s].shape == (B, 3, T, LENGTHS[s])
        np.testing.assert_allclose(att_t[s].numpy(), np.asarray(att_j[s]),
                                   rtol=0, atol=ATOL)


def test_call_matches_jax(twins):
    """Plain forward with per-sample timesteps and padded text streams."""
    jm, params, tm = twins
    rng = np.random.default_rng(1)
    sample = rng.standard_normal((B, T, LAT)).astype(np.float32)
    cond = _conditions(rng, B)
    masks = _masks(B, [5, 16, 1])
    ts = np.array([999, 480, 0], np.int32)

    np_j, att_j = jm.denoiser.apply(
        {"params": params["denoiser"]}, jnp.asarray(sample),
        jnp.asarray(ts), cond, masks)
    with torch.no_grad():
        np_t, att_t = tm.denoiser(torch.from_numpy(sample),
                                  torch.from_numpy(ts), _t(cond), _t(masks))
    np.testing.assert_allclose(np_t.numpy(), np.asarray(np_j),
                               rtol=0, atol=ATOL)
    for s in COND_STREAMS:
        np.testing.assert_allclose(att_t[s].numpy(), np.asarray(att_j[s]),
                                   rtol=0, atol=ATOL)
