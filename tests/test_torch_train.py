"""Stage-2 training losses and gradients of the PyTorch port against
``convofusion_tpu``'s ``train_diffusion_loss`` at the tiny geometry, fp32.

Both sides hold the same weights: the port's seeded init, carried into a
JAX tree by the JAX package's own converters (``compat/torch_loader``,
``models/t5.t5_params_from_torch``; ``test_torch_weights.py`` pins them
as the exact inverse of ``state_dict_from_jax``).  The port replays JAX's
key splits (:467) through ``draws``: the VAE's reparameterisation noise,
the modality-dropout groups, the diffusion noise and the timesteps.
Dropout is 0 on both sides (the JAX audio encoder is cloned with rate 0
inside the test).  JAX's gradient tree goes through ``state_dict_from_jax``,
which is linear (transposes and concatenations), onto the port's names.

Tolerances: the loss within 1e-5 relative; each gradient within
1e-6 + 1e-4 max|g| of its tensor (fp32 sums of a few hundred terms in
another order).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.compat import torch_loader as tl
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.t5 import t5_params_from_torch
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train.trainer import Trainer, frozen_names

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# int(0.1 * 10) = 1: six rows drop one modality group each, four keep all
B = 10
LAT = 32


# ------------------------------------------------------------ shared helpers
def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def jax_params_from_port(model):
    """The port model's weights as a JAX ``init_params``-shaped tree, by the
    JAX package's converters."""
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    cfg = model.cfg
    out = {}
    if model.vae is not None:    # none on raw motion (vae_type 'no')
        out["vae"] = tl.vae_params(_sub(sd, "vae."), cfg["latent_dim"][1],
                                   cfg["motion_vae"]["num_layers"])
    if model.stage != "vae":
        out["denoiser"] = tl.denoiser_params(
            _sub(sd, "denoiser."), cfg["denoiser"]["text_encoded_dim"],
            cfg["denoiser"]["num_layers"])
        out["text_encoder"] = {
            "text_model": t5_params_from_torch(
                _sub(sd, "text_encoder.text_model."),
                cfg["text_encoder"]["num_layers"]),
            "projection_1": tl.linear(sd, "text_encoder.projection.1")}
        out["audio_encoder"] = {
            n: tl.linear(sd, f"audio_encoder.{k}") for n, k in (
                ("main_0", "main.0"), ("main_3", "main.3"),
                ("out_net", "out_net"))}
        out["condition_fuser"] = {
            n: tl.embedding(sd, f"condition_fuser.{n}")
            for n in ("active_passive_emb", "lsn_id_emb")}
    return out


def port_config(stage="diffusion", **loss):
    """TINY (TINY_VAE for stage 1) with every dropout rate 0."""
    cfg = copy.deepcopy(TINY_VAE if stage == "vae" else TINY)
    cfg["audio_encoder"]["dropout"] = 0.0
    cfg["train"]["loss"].update(loss)
    return cfg


def jax_model(stage="diffusion", **loss):
    """tiny_config(stage) with LOSS overrides and the audio encoder's
    dropout at 0."""
    cfg = tiny_config(stage)
    for k, v in loss.items():
        cfg.LOSS[k.upper()] = v
    jm = JaxConvofusion(cfg)
    if stage != "vae":
        jm.audio_encoder = jm.audio_encoder.clone(dropout=0.0)
    return jm


def diffusion_draws(jm, key, b, lat=LAT):
    """What JAX's train_diffusion_loss draws from ``key`` (:467-517)."""
    k_enc, k_drop, k_noise, k_t, _ = jax.random.split(key, 5)
    n = jm.noise_scheduler.num_train_timesteps
    return {
        "eps": np.array(jax.random.normal(k_enc, (2, b, 8, lat))),
        "group": np.array(jm._dropout_groups(k_drop, b)),
        "noise": np.array(jax.random.normal(k_noise, (b, 16, lat))),
        "timesteps": np.array(jax.random.randint(k_t, (b,), 0, n)),
    }


def vae_draws(key, b, lat=LAT):
    """What JAX's train_vae_loss draws from ``key`` (:285-288)."""
    k_sample, _ = jax.random.split(key)
    return {"eps": np.array(jax.random.normal(k_sample, (2, b, 8, lat)))}


def jax_value_and_grad(jm, loss_name, params, batch, key):
    fn = getattr(jm, loss_name)
    (loss, terms), grads = jax.jit(jax.value_and_grad(
        lambda p, b: fn(p, b, key), has_aux=True))(params, batch)
    return (float(loss), {k: float(v) for k, v in terms.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def port_value_and_grad(model, batch, draws):
    """The stage's loss and the trainable parameters' gradients, through
    the trainer's train mode (dropout 0 here)."""
    trainer = Trainer(model)
    with trainer.training():
        loss, terms = trainer.compute_grads(batch, None, draws)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
    assert not model.training
    return float(loss), {k: float(v) for k, v in terms.items()}, grads


def assert_match(model, got, want):
    """Loss, every term, and every gradient; parameters that are frozen in
    the model's stage have no gradient in the port and a zero one in
    JAX."""
    loss_p, terms_p, grads_p = got
    loss_j, terms_j, grads_j = want
    assert abs(loss_p - loss_j) <= LOSS_RTOL * abs(loss_j), (loss_p, loss_j)
    assert set(terms_p) == set(terms_j)
    for k in terms_j:
        assert abs(terms_p[k] - terms_j[k]) <= LOSS_RTOL * abs(terms_j[k]) \
            + 1e-12, k
    want_sd = state_dict_from_jax(grads_j)
    frozen = frozen_names(model.stage)
    n_trained = 0
    for name, _ in model.named_parameters():
        w = want_sd[name].numpy()
        if any(name == f or name.startswith(f + ".") for f in frozen):
            assert name not in grads_p and np.abs(w).max() == 0.0, name
            continue
        g = grads_p[name].numpy()
        tol = GRAD_ATOL + GRAD_RTOL * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
        n_trained += 1
    assert n_trained == len(grads_p) > 0


# ------------------------------------------------------------------ stage 2
@pytest.fixture(scope="module")
def stage2():
    pm = Convofusion(port_config(), device="cpu", seed=0)
    params = jax_params_from_port(pm)
    jm = jax_model()
    raw = jax_synthetic.synthetic_raw_batch(1, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    return pm, params, jm, jb, tb


def _layout(name, pm, params, jm, jb, tb):
    """The batch in one of the layouts cli/train and bench.py feed, each
    side built with its own functions."""
    jb, tb = dict(jb), dict(tb)
    trunk = "trunk" in name or name == "cached_one_row"
    posterior = "posterior" in name or name == "cached_one_row"
    rows = 1 if name == "cached_one_row" else B
    if trunk:
        for who in ("spk", "lsn", "uncond"):
            ids, mask = f"{who}_ids", f"{who}_tmask"
            jb[f"{who}_trunk"] = jm.encode_text_trunk(
                params, jb[ids][:rows if who == "uncond" else B],
                jb[mask][:rows if who == "uncond" else B])
            tb[f"{who}_trunk"] = pm.encode_text_trunk(
                tb[ids][:rows if who == "uncond" else B],
                tb[mask][:rows if who == "uncond" else B])
        for side in (jb, tb):
            side["uncond_tmask"] = side["uncond_tmask"][:rows]
            for k in ("spk_ids", "lsn_ids", "uncond_ids"):
                del side[k]
    if posterior:
        jb["vae_mu"], jb["vae_logvar"] = jm.encode_vae_posterior(
            params, jb["motion_lsn"])
        tb["vae_mu"], tb["vae_logvar"] = pm.encode_vae_posterior(
            tb["motion_lsn"])
        del jb["motion_lsn"], tb["motion_lsn"]
    return jb, tb


@pytest.mark.parametrize("layout", ["ids", "cached_trunk", "cached_posterior",
                                    "cached_one_row"])
def test_diffusion_loss_and_grads_match_jax(stage2, layout):
    """Token ids; cached T5 trunk states (uncond trunk at batch B); the
    frozen VAE's cached posterior; and both caches with a one-row uncond
    trunk, as bench.py --cached-text --cached-vae feeds them."""
    pm, params, jm, jb, tb = stage2
    jb, tb = _layout(layout, pm, params, jm, jb, tb)
    key = jax.random.PRNGKey(3)
    want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb, key)
    got = port_value_and_grad(pm, tb, diffusion_draws(jm, key, B))
    assert_match(pm, got, want)


def test_diffusion_loss_with_every_term_matches_jax(stage2):
    """The prior, latent and guided-attention terms on (the x0 prediction
    through the sampling scheduler's clip, betas[t] weights, the batch
    chunked in halves)."""
    pm, params, _, jb, tb = stage2
    loss = {"lambda_prior": 0.5, "lambda_latent": 0.1,
            "lambda_guided_attention": 1e-3}
    jm = jax_model(**loss)
    saved = pm.loss_weights
    pm.loss_weights = {**saved, **loss}
    try:
        key = jax.random.PRNGKey(5)
        want = jax_value_and_grad(jm, "train_diffusion_loss", params, jb,
                                  key)
        got = port_value_and_grad(pm, tb, diffusion_draws(jm, key, B))
    finally:
        pm.loss_weights = saved
    assert {"prior_loss", "latent_loss", "guidedattention_loss"} <= \
        set(got[1])
    assert_match(pm, got, want)


@pytest.mark.parametrize("layout", ["ids", "cached_trunk"])
def test_modality_dropout_matches_jax(stage2, layout):
    """apply_modality_dropout on JAX's groups, field by field, exactly;
    random trunk states stand in for the T5 trunk."""
    pm, _, jm, jb, tb = stage2
    b = 20    # two rows a group
    raw = jax_synthetic.synthetic_raw_batch(9, b)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    if layout == "cached_trunk":
        rng = np.random.default_rng(0)
        for who, rows in (("spk", b), ("lsn", b), ("uncond", 1)):
            arr = rng.standard_normal((rows, 16, 32)).astype(np.float32)
            jb[f"{who}_trunk"], tb[f"{who}_trunk"] = arr, torch.from_numpy(arr)
    key = jax.random.PRNGKey(11)
    group = np.array(jm._dropout_groups(key, b))
    assert sorted(np.bincount(group, minlength=7)) == [2] * 6 + [8]
    want = jm.apply_modality_dropout(key, jb)
    got = pm.apply_modality_dropout(tb, draws={"group": group})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_dropout_groups_from_the_generator():
    """The port's own draw: six groups of int(uncondp * B) rows, the rest
    group 6; one generator seed, one grouping; a batch under 10 drops
    nothing."""
    pm = Convofusion(port_config(), device="cpu", seed=None)

    def groups(b, seed):
        return pm._dropout_groups(b, torch.Generator().manual_seed(seed),
                                  "cpu")

    g = groups(64, 0)
    assert g.tolist().count(6) == 64 - 36
    assert all(g.tolist().count(i) == 6 for i in range(6))
    assert torch.equal(g, groups(64, 0)) and not torch.equal(g, groups(64, 1))
    assert groups(9, 0).tolist() == [6] * 9
