"""Condition encoders of the PyTorch port against the JAX package at the
tiny geometry, fp32, on JAX ``init_params`` weights: the T5 stack plus
projection, the mel encoder, the fuser, ``encode_conditions`` and
``encode_uncond``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops.transformer import COND_STREAMS

B = 3
# fp32 on both sides: GEMM summation order and rsqrt/erf ulps through two
# T5 blocks and the MLPs, on outputs of O(1)
ATOL = 2e-5


@pytest.fixture(scope="module")
def twins():
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    raw = jax_synthetic.synthetic_raw_batch(5, B)
    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    return jm, params, tm, jbatch, tbatch


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_prepared_batch_matches(twins):
    _, _, _, jbatch, tbatch = twins
    for k, v in tbatch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]), k)


def test_text_encoder(twins):
    """T5 stack (padded rows, relative bias of block 0) + projection."""
    jm, params, tm, jbatch, tbatch = twins
    want = jm.encode_text(params, jbatch["lsn_ids"], jbatch["lsn_tmask"])
    got = tm.encode_text(tbatch["lsn_ids"], tbatch["lsn_tmask"])
    assert got.shape == (B, 16, 64)
    _close(got, want)
    assert not any(p.requires_grad
                   for p in tm.text_encoder.text_model.parameters())


def test_audio_encoder_and_fuser(twins):
    jm, params, tm, jbatch, tbatch = twins
    want = jm.audio_encoder.apply({"params": params["audio_encoder"]},
                                  jnp.asarray(jbatch["melspec_lsn"]))
    with torch.no_grad():
        got = tm.audio_encoder(tbatch["melspec_lsn"])
    _close(got, want)

    rng = np.random.default_rng(0)
    spk, tl = (rng.standard_normal((B, 16, 64)).astype(np.float32)
               for _ in range(2))
    want = jm.condition_fuser.apply(
        {"params": params["condition_fuser"]}, spk, np.asarray(want), tl,
        jbatch["active_passive_lsn"], jbatch["lsn_id"])
    with torch.no_grad():
        got = tm.condition_fuser(torch.from_numpy(spk), got,
                                 torch.from_numpy(tl),
                                 tbatch["active_passive_lsn"],
                                 tbatch["lsn_id"])
    for s in COND_STREAMS:
        _close(got[s], want[s])


def test_encode_conditions_and_uncond(twins):
    jm, params, tm, jbatch, tbatch = twins
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    cond_j, masks_j = jm.encode_conditions(params,
                                           *(jbatch[k] for k in keys))
    with torch.no_grad():
        cond_t, masks_t = tm.encode_conditions(*(tbatch[k] for k in keys))
        unc_t, umasks_t = tm.encode_uncond(tbatch)
    unc_j, umasks_j = jm.encode_uncond(params, jbatch)
    for s in COND_STREAMS:
        _close(cond_t[s], cond_j[s])
        assert unc_t[s].shape[0] == 1
        _close(unc_t[s], unc_j[s])
    for s in ("spkemb", "tlsn"):
        np.testing.assert_array_equal(masks_t[s].numpy(), masks_j[s])
        np.testing.assert_array_equal(umasks_t[s].numpy(), umasks_j[s])
