"""An ablated VAE through the whole pipeline of the PyTorch port against the
JAX package, fp32, tiny geometry: the post-norm VAE with learned PEs and
``TRAIN.ABLATION.MLP_DIST``, and the denoiser with a learned memory PE.

Both sides take the same dotlist overrides over ``tiny_config`` (the port's
through ``from_cfg``), the same weights (JAX ``init_params``, carried by
``compat/from_jax``) and the same inputs and noise:
- ``sample()`` at DDIM-4, JAX through its step kernel (interpret mode), the
  port with ``TPU.PALLAS_STEP`` true (the kernel's plain version on the
  CPU, 4 calls) and false (the plain combine and update, no call): both
  within the sampler's tolerances of JAX (``test_torch_sampler.py``), and
  one step of each within 1e-5 of the other;
- one stage-1 and one stage-2 loss with their gradients, JAX's draws
  replayed (``test_torch_train.py``'s tolerances).
The audio encoder's dropout is 0 on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.config import testing as jax_testing
from convofusion_tpu.config.omega import OmegaConf as JaxOmegaConf
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch import config as C
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config.omega import OmegaConf
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion
from test_torch_sampler import ATOL, RTOL, _jax_noise_sequence
from test_torch_train import (
    assert_match,
    diffusion_draws,
    jax_value_and_grad,
    port_value_and_grad,
    vae_draws,
)

ABLATED_VAE = [
    "model.motion_vae.params.normalize_before=false",
    "model.motion_vae.params.position_embedding=learned",
    "TRAIN.ABLATION.MLP_DIST=true",
]
ABLATED = ABLATED_VAE + [
    "model.denoiser.params.position_embedding=learned",
    "model.scheduler.variant=ddim",
]
B, STEPS = 2, 4
# one reverse step of the port's two step paths: the same arithmetic in
# another order (6e-8 in the latents, 1.7e-6 in the motion at this size)
PATHS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twins(stage, overrides):
    """(JAX model, its init_params, the port model on those weights); the
    audio encoder's dropout 0 on both sides."""
    jcfg = JaxOmegaConf.merge(jax_testing.tiny_config(stage),
                              JaxOmegaConf.from_dotlist(overrides))
    jm = JaxConvofusion(jcfg)
    if stage != "vae":
        jm.audio_encoder = jm.audio_encoder.clone(dropout=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    pcfg = C.from_cfg(OmegaConf.merge(C.tiny_config(stage),
                                      OmegaConf.from_dotlist(overrides)))
    pcfg["audio_encoder"]["dropout"] = 0.0
    pm = Convofusion(pcfg, device="cpu", seed=None, stage=stage)
    pm.load_state_dict(state_dict_from_jax(params))
    return jm, params, pm


@pytest.fixture(scope="module")
def stage2():
    jm, params, pm = twins("diffusion", ABLATED)
    raw = jax_synthetic.synthetic_raw_batch(4, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    return jm, params, pm, jb, tb


def test_the_ablated_trees(stage2):
    _, params, pm, _, _ = stage2
    vae = params["vae"]
    assert vae["body_global_motion_token"].shape == (1, 32)
    assert {"body_dist_layer", "hands_dist_layer"} <= set(vae)
    for pe in ("query_pos_encoder", "query_pos_decoder", "mem_pos_decoder"):
        assert vae[pe]["pe"].shape == (1024, 32)
    assert params["denoiser"]["mem_pos"]["pe"].shape == (1024, 64)
    assert pm.vae.mlp_dist and not \
        pm.vae.body_encoder.middle_block.normalize_before


def test_sample_both_step_paths_match_jax(stage2, monkeypatch):
    jm, params, pm, jb, tb = stage2
    key = jax.random.PRNGKey(1)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k: jm.sample(p, b, k, num_inference_steps=STEPS))(
            params, jb, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, 32))

    calls, step = [], port.guided_step

    def counting_step(*args):
        calls.append(tuple(args[0].shape))
        return step(*args)

    monkeypatch.setattr(port, "guided_step", counting_step)
    out = {}
    for use in (True, False):
        pm.use_step_kernel = use
        assert pm.uses_step_kernel() == use
        calls.clear()
        out[use] = pm.sample(tb, num_inference_steps=STEPS,
                             init_noise=torch.from_numpy(init),
                             step_noise=torch.from_numpy(steps))
        assert calls == ([(7, B, 16, 32)] * STEPS if use else [])
        for got, want in zip(out[use], (motion_j, lat_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    pm.use_step_kernel = True


def test_one_step_of_both_paths_agrees(stage2):
    """One reverse step from the same latents: the kernel's op order and the
    plain combine + ``scheduler.step`` agree within 1e-5 (over several
    steps the two roundings compound through the x37.5 guidance and the
    x0 clip, to a few 1e-5 in the latents at DDIM-4; both stay within the
    sampler's tolerances of JAX above)."""
    _, _, pm, _, tb = stage2
    rng = np.random.default_rng(7)
    init = torch.from_numpy(rng.standard_normal((B, 16, 32)).astype(
        np.float32))
    step = torch.from_numpy(rng.standard_normal((1, B, 16, 32)).astype(
        np.float32))
    out = {}
    for use in (True, False):
        pm.use_step_kernel = use
        out[use] = pm.sample(tb, num_inference_steps=1, init_noise=init,
                             step_noise=step)
    pm.use_step_kernel = True
    for a, b in zip(out[True], out[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PATHS_ATOL)


def test_stage2_loss_and_grads_match_jax(stage2):
    jm, params, pm, jb, tb = stage2
    key = jax.random.PRNGKey(3)
    want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb, key)
    got = port_value_and_grad(pm, tb, diffusion_draws(jm, key, B))
    assert_match(pm, got, want)
    # the learned memory PE trains; the VAE's tables are frozen in stage 2
    assert np.abs(state_dict_from_jax(want[2])[
        "denoiser.mem_pos.pe"].numpy()).max() > 0


def test_stage1_loss_and_grads_match_jax():
    jm, params, pm = twins("vae", ABLATED_VAE)
    motion = jax_synthetic.synthetic_raw_batch(5, B)["motion_lsn"]
    key = jax.random.PRNGKey(6)
    want = jax_value_and_grad(jm, "train_vae_loss", params,
                              {"motion": motion}, key)
    got = port_value_and_grad(pm, {"motion": torch.from_numpy(motion)},
                              vae_draws(key, B))
    assert_match(pm, got, want)
    assert {"vae.body_dist_layer.weight", "vae.query_pos_encoder.pe"} <= \
        set(got[2])


def test_scheduler_of_the_port_is_ddim(stage2):
    """The overrides reached both sides' schedulers."""
    jm, _, pm, _, _ = stage2
    assert pm.scheduler.variant == jm.scheduler.variant == "ddim"
    assert pm.scheduler.clip_sample and pm.use_step_kernel
