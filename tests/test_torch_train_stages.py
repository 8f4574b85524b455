"""Stage-1 (``train_vae_loss``) and joint-stage (``train_vae_diffusion_loss``)
losses and gradients of the PyTorch port against ``convofusion_tpu`` at the
tiny geometry, fp32, with the draws and tolerances of
``test_torch_train.py``: the loss within 1e-5 relative, each gradient within
1e-6 + 1e-4 max|g|.  Stage 1 trains the whole VAE; the joint stage trains
the VAE through its own loss only (the diffusion part encodes with the VAE
frozen, JAX :487-489)."""
import jax
import torch

from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from test_torch_train import (
    B,
    assert_match,
    diffusion_draws,
    jax_model,
    jax_params_from_port,
    jax_value_and_grad,
    port_config,
    port_value_and_grad,
    vae_draws,
)


def test_vae_loss_and_grads_match_jax():
    """Recon (root x10, hand/arm x5), KL, Laplace recon and bone-length
    terms of the production stage-1 weights, on a stage='vae' model."""
    pm = Convofusion(port_config("vae"), device="cpu", seed=0, stage="vae")
    assert not hasattr(pm, "denoiser")
    params = jax_params_from_port(pm)
    assert set(params) == {"vae"}
    jm = jax_model("vae")
    motion = jax_synthetic.synthetic_raw_batch(2, B)["motion_lsn"]
    key = jax.random.PRNGKey(4)
    want = jax_value_and_grad(jm, "train_vae_loss", params,
                              {"motion": motion}, key)
    got = port_value_and_grad(pm, {"motion": torch.from_numpy(motion)},
                              vae_draws(key, B))
    assert set(got[1]) == {"recons_feature", "kl_motion", "recons_laplace",
                           "bonelen_feature", "total"}
    assert_match(pm, got, want)


def test_vae_diffusion_loss_and_grads_match_jax():
    """The two losses summed, with their terms under their names; the key
    split of :318 replayed into ``draws['vae']`` and
    ``draws['diffusion']``."""
    pm = Convofusion(port_config(), device="cpu", seed=1,
                     stage="vae_diffusion")
    params = jax_params_from_port(pm)
    jm = jax_model("vae_diffusion")
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    key = jax.random.PRNGKey(6)
    k_vae, k_diff = jax.random.split(key)
    want = jax_value_and_grad(jm, "train_vae_diffusion_loss", params, jb,
                              key)
    got = port_value_and_grad(pm, tb, {
        "vae": vae_draws(k_vae, B),
        "diffusion": diffusion_draws(jm, k_diff, B)})
    assert "vae_total" in got[1] and "inst_loss" in got[1]
    assert_match(pm, got, want)
    # the VAE trains here (its gradient is the VAE loss's)
    assert float(got[2]["vae.body_encoder.norm.weight"].abs().max()) > 0
