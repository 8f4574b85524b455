"""The ``trans_enc`` denoiser through the pipeline of the PyTorch port
against the JAX package, fp32, tiny geometry, and the knobs where both
raise.

``trans_enc`` trains and samples unguided in JAX (the pipeline's five
streams appended to the latent tokens); guided sampling fails there (no
``condition_embedding``, no ``decoder``), and the port raises before any
work.  The same weights (JAX ``init_params`` through ``compat/from_jax``),
inputs, draws and noise on both sides: one stage-2 loss with its
gradients (``test_torch_train.py``'s tolerances) and an unguided DDIM-2
``sample()`` (``test_torch_sampler.py``'s), with no step-kernel call.
Where JAX raises, the port raises: a one-tensor condition with
``trans_enc`` in the pipeline, the trans_dec denoiser's post-norm, and
``TRAIN.ABLATION.CAUSAL_ATTN``.
"""
import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.config import testing as jax_testing
from convofusion_tpu.config.omega import OmegaConf as JaxOmegaConf
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.factory import build_denoiser
from convofusion_tpu_torch import config as C
from convofusion_tpu_torch.config.omega import OmegaConf
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion
from test_torch_ablations_pipeline import twins
from test_torch_sampler import ATOL, RTOL, _jax_noise_sequence
from test_torch_train import (
    assert_match,
    diffusion_draws,
    jax_value_and_grad,
    port_value_and_grad,
)

TRANS_ENC = ["model.denoiser.params.arch=trans_enc",
             "model.scheduler.variant=ddim"]
UNGUIDED = TRANS_ENC + ["model.guidance_scale=1.0"]
B, STEPS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unguided():
    jm, params, pm = twins("diffusion", UNGUIDED)
    raw = jax_synthetic.synthetic_raw_batch(8, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    return jm, params, pm, jb, tb


def test_the_trans_enc_tree(unguided):
    _, params, pm, _, _ = unguided
    assert set(params["denoiser"]) == {"bh_embedding", "encoder",
                                       "latent_embd", "latent_proj",
                                       "time_embedding"}
    assert pm.denoiser.arch == "trans_enc"
    assert not hasattr(pm.denoiser, "decoder")


def test_loss_and_grads_match_jax(unguided):
    jm, params, pm, jb, tb = unguided
    key = jax.random.PRNGKey(9)
    want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb, key)
    got = port_value_and_grad(pm, tb, diffusion_draws(jm, key, B))
    assert_match(pm, got, want)
    assert any(n.startswith("denoiser.encoder.") for n in got[2])


def test_unguided_sample_matches_jax(unguided, monkeypatch):
    jm, params, pm, jb, tb = unguided
    key = jax.random.PRNGKey(10)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k: jm.sample(p, b, k, num_inference_steps=STEPS))(
            params, jb, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, 32))

    def no_step(*args):
        raise AssertionError("unguided sampling took the step kernel")

    monkeypatch.setattr(port, "guided_step", no_step)
    motion_t, lat_t, att = pm.sample(
        tb, num_inference_steps=STEPS, init_noise=torch.from_numpy(init),
        step_noise=torch.from_numpy(steps), capture_attention="all")
    assert att == {}
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j),
                               rtol=RTOL, atol=ATOL)


def test_guided_sample_raises_in_both(unguided, monkeypatch):
    """JAX fails on the parameters trans_enc lacks; the port raises before
    it encodes anything."""
    _, params, pm, jb, tb = unguided
    jcfg = JaxOmegaConf.merge(jax_testing.tiny_config("diffusion"),
                              JaxOmegaConf.from_dotlist(TRANS_ENC))
    guided = JaxConvofusion(jcfg)
    with pytest.raises(Exception, match="condition_embedding"):
        guided.sample(params, jb, jax.random.PRNGKey(0),
                      num_inference_steps=STEPS)
    pm.do_classifier_free_guidance = True
    monkeypatch.setattr(pm, "encode_conditions", None)
    try:
        with pytest.raises(ValueError, match="trans_enc"):
            pm.sample(tb, torch.Generator().manual_seed(0),
                      num_inference_steps=STEPS)
        with pytest.raises(ValueError, match="trans_enc"):
            pm.diffusion_reverse({}, {}, {}, {}, B, STEPS,
                                 torch.Generator().manual_seed(0))
    finally:
        pm.do_classifier_free_guidance = False


@pytest.mark.parametrize("condition", ["text", "action"])
def test_one_tensor_condition_with_trans_enc_raises_in_both(condition):
    overrides = TRANS_ENC + [f"model.condition={condition}"]
    jcfg = JaxOmegaConf.merge(jax_testing.tiny_config("diffusion"),
                              JaxOmegaConf.from_dotlist(overrides))
    with pytest.raises((TypeError, ValueError)):
        JaxConvofusion(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = C.from_cfg(OmegaConf.merge(C.tiny_config("diffusion"),
                                     OmegaConf.from_dotlist(overrides)))
    assert cfg["denoiser"]["condition"] == condition
    with pytest.raises(ValueError, match="model.condition"):
        Convofusion(cfg, device="cpu")


def test_trans_dec_post_norm_raises_in_both():
    overrides = ["model.denoiser.params.normalize_before=false"]
    jcfg = JaxOmegaConf.merge(jax_testing.tiny_config("diffusion"),
                              JaxOmegaConf.from_dotlist(overrides))
    with pytest.raises(AssertionError):
        JaxConvofusion(jcfg).init_params(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="normalize_before"):
        C.from_cfg(OmegaConf.merge(C.tiny_config("diffusion"),
                                   OmegaConf.from_dotlist(overrides)))


def test_causal_attn_raises_in_both():
    """The same error in both: JAX's factory raises ValueError (a value
    JAX rejects), and so does the port's from_cfg."""
    with pytest.raises(ValueError, match="CAUSAL_ATTN"):
        build_denoiser(ablation={"CAUSAL_ATTN": True})
    with pytest.raises(ValueError, match="CAUSAL_ATTN"):
        C.from_cfg(OmegaConf.merge(C.tiny_config("diffusion"),
                                   OmegaConf.from_dotlist(
                                       ["TRAIN.ABLATION.CAUSAL_ATTN=true"])))
