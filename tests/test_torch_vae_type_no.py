"""Diffusion on raw motion (``TRAIN.ABLATION.VAE_TYPE: no``) in the
PyTorch port against the JAX package (convofusion_tpu/models/
convofusion.py:84-110, :481-492, :928-931; tests/test_vae_type_no.py).

Both sides hold the port's seeded weights (no VAE), carried into a JAX tree
by the JAX package's converters (``test_torch_train.jax_params_from_port``)
and replay JAX's draws.  fp32.  Tolerances: the stage-2 loss and gradients
as tests/test_torch_train.py argues (1e-5 relative; 1e-6 + 1e-4 max|g|);
a guided DDIM-3 sample as tests/test_torch_sampler.py argues (2e-4 +
2e-5 relative); the step kernel's plain version against JAX's
interpret-mode Pallas kernel within 2e-5, as tests/test_torch_guided_step.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu import config as jax_config
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.ops.pallas_step import fused_guided_step
from convofusion_tpu_torch import config as C
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops.guided_step import (
    ALIGN,
    THREADS,
    TILE,
    _launch_geometry,
    guided_step_reference,
)
from test_torch_guided_step import CASES
from test_torch_sampler import ATOL, RTOL, _jax_noise_sequence
from test_torch_train import (
    assert_match,
    jax_params_from_port,
    jax_value_and_grad,
    port_config,
    port_value_and_grad,
)

B, STEPS, T, NFEATS = 2, 3, 128, 189
STEP_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_raw_model(scheduler=None, vae_type="no"):
    """tiny_config('diffusion') on raw motion, the audio encoder's dropout
    at 0 (as tests/test_torch_train.py's JAX side).  JAX's denoiser reads
    its latent width from ``model.latent_dim`` (modules/denoiser.yaml), so
    the config takes the raw-motion geometry [1, 189]."""
    cfg = tiny_config("diffusion")
    cfg.TRAIN.ABLATION.VAE_TYPE = vae_type
    cfg.model.latent_dim = [1, NFEATS]
    if scheduler:
        cfg.model.scheduler["variant"] = scheduler
    jm = JaxConvofusion(cfg)
    jm.audio_encoder = jm.audio_encoder.clone(dropout=0.0)
    return jm


@pytest.fixture(scope="module")
def raw_model():
    cfg = port_config()
    cfg["vae_type"] = "no"
    cfg["latent_dim"] = [1, NFEATS]
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=STEPS)
    pm = Convofusion(cfg, device="cpu", seed=0)
    return pm, jax_params_from_port(pm)


def test_geometry_and_weights(raw_model):
    """latent tokens = max_len and latent dim = nfeats, no VAE and no
    ``vae.`` weight on either side; ``state_dict_from_jax`` carries the
    VAE-less tree."""
    pm, params = raw_model
    jm = jax_raw_model()
    assert (pm.latent_tokens, pm.latent_dim) == (T, NFEATS) == (
        jm.latent_tokens, jm.latent_dim)
    assert pm.vae is None and jm.vae is None
    assert "vae" not in params
    sd = pm.state_dict()
    assert not any(k.startswith("vae.") for k in sd)
    got = state_dict_from_jax(params)
    assert set(got) == set(sd)
    for k, v in got.items():
        assert torch.equal(v, sd[k].float()), k


def test_stage2_loss_and_grads_match_jax(raw_model):
    """The stage-2 loss on raw motion: the motion itself is noised, no
    reparameterisation draw (JAX draws none either)."""
    pm, params = raw_model
    jm = jax_raw_model()
    b = 10
    raw = jax_synthetic.synthetic_raw_batch(1, b)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    key = jax.random.PRNGKey(3)
    _, k_drop, k_noise, k_t, _ = jax.random.split(key, 5)
    draws = {
        "group": np.array(jm._dropout_groups(k_drop, b)),
        "noise": np.array(jax.random.normal(k_noise, (b, T, NFEATS))),
        "timesteps": np.array(jax.random.randint(
            k_t, (b,), 0, jm.noise_scheduler.num_train_timesteps)),
    }
    want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb, key)
    got = port_value_and_grad(pm, tb, draws)
    assert_match(pm, got, want)


def test_guided_sample_matches_jax(raw_model, monkeypatch):
    """A guided DDIM-3 ``sample()``: the motion is the final latents
    (the identity decode), and each step goes through the step kernel's
    gate on (7, B, 128, 189) planes, JAX's in interpret mode."""
    pm, params = raw_model
    jm = jax_raw_model("ddim")
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    key = jax.random.PRNGKey(4)
    motion_j, lat_j, _ = jax.jit(lambda p, b, k: jm.sample(
        p, b, k, num_inference_steps=STEPS))(params, jb, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, T, NFEATS))
    planes = []
    real = port.guided_step

    def counted(np7, *args):
        planes.append(tuple(np7.shape))
        return real(np7, *args)

    monkeypatch.setattr(port, "guided_step", counted)
    assert pm.uses_step_kernel()
    motion, lat = pm.sample(tb, num_inference_steps=STEPS,
                            init_noise=torch.from_numpy(init),
                            step_noise=torch.from_numpy(steps))
    assert planes == [(7, B, T, NFEATS)] * STEPS
    assert torch.equal(motion, lat) and motion.shape == (B, T, NFEATS)
    np.testing.assert_array_equal(np.asarray(motion_j), np.asarray(lat_j))
    np.testing.assert_allclose(lat.numpy(), np.asarray(lat_j), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_plain_version_at_raw_motion_shape(dtype):
    """``guided_step_reference`` at (7, 2, 128, 189) against the Pallas
    kernel in interpret mode, in the DDPM, final-DDPM and DDIM cases, fp32
    and bf16 branch planes (JAX casts the planes to fp32 inside)."""
    rng = np.random.default_rng(0)
    np7 = rng.standard_normal((7, B, T, NFEATS)).astype(np.float32)
    lat, noise = (rng.standard_normal((B, T, NFEATS)).astype(np.float32)
                  for _ in range(2))
    t7 = torch.from_numpy(np7).to(getattr(torch, dtype))
    j7 = jnp.asarray(np7).astype(getattr(jnp, dtype))
    for name, (a_t, a_prev, is_ddpm, add_noise) in sorted(CASES.items()):
        scalars = (float(a_t), float(a_prev), 7.5, is_ddpm, add_noise, 1.0)
        want = fused_guided_step(j7, jnp.asarray(lat), jnp.asarray(noise),
                                 *map(jnp.float32, scalars), interpret=True)
        got = guided_step_reference(t7, torch.from_numpy(lat),
                                    torch.from_numpy(noise), *scalars)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("batch", [2, 4, 96])
@pytest.mark.parametrize("elem", [2, 4])
def test_launch_geometry_at_raw_motion_shape(batch, elem):
    """The kernel's tiles over B x 128 x 189 elements (odd 189: the
    wrapper needs only a multiple of 8 in all): every element in one
    block, every bulk copy 16-byte aligned and sized, a short last block
    where the tile does not divide the latents (1,512 full blocks of 1,536
    at B = 96)."""
    n = batch * T * NFEATS
    geom = _launch_geometry(n, elem, TILE[elem], THREADS)
    assert geom.blocks == -(-n // TILE[elem])
    covered = 0
    for block in geom.copies:
        lat = [c for c in block if c.source == "latents"][0]
        covered += lat.nbytes // 4
        for c in block:
            assert c.offset % ALIGN == 0 and c.nbytes % ALIGN == 0, c
    assert covered == n
    if batch == 96 and elem == 2:
        assert geom.blocks == 1512


def test_yaml_no_is_normalised_and_builds_no_vae():
    """``VAE_TYPE: no`` unquoted is YAML's False; both packages read it as
    'no' and build no VAE."""
    over = ["TRAIN.ABLATION.VAE_TYPE=no", "model.latent_dim=[1,189]"]
    cfg = C.load_config(f"{C.DEFAULTS_DIR}/config_cf_beatdnd.yaml",
                        overrides=over)
    jcfg = jax_config.load_config(
        f"{jax_config.DEFAULTS_DIR}/config_cf_beatdnd.yaml", overrides=over)
    assert cfg.TRAIN.ABLATION.VAE_TYPE is False
    assert jcfg.TRAIN.ABLATION.VAE_TYPE is False
    tiny = copy.deepcopy(C.TINY)
    tiny["vae_type"] = C.from_cfg(cfg)["vae_type"]
    assert tiny["vae_type"] == "no"
    assert Convofusion(tiny, device="cpu", seed=None).vae is None
    assert jax_raw_model(vae_type=False).vae_type == "no"


def test_vae_stage_raises():
    """No VAE, no stage 1: TypeError on both sides
    (tests/test_vae_type_no.py:65-72)."""
    tiny = copy.deepcopy(C.TINY_VAE)
    tiny["vae_type"] = "no"
    pm = Convofusion(tiny, device="cpu", seed=0, stage="vae")
    motion = torch.zeros(2, T, NFEATS)
    with pytest.raises(TypeError, match="VAE"):
        pm.train_vae_loss({"motion": motion})
    cfg = tiny_config("vae")
    cfg.TRAIN.ABLATION.VAE_TYPE = "no"
    with pytest.raises(TypeError):
        JaxConvofusion(cfg).train_vae_loss(None, {"motion": motion.numpy()},
                                           jax.random.PRNGKey(0))
