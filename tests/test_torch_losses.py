"""The port's training losses against ``convofusion_tpu/losses/diffvae.py``
and ``ops/smoothing.py`` on the same seeded numpy inputs.

Each case runs twice on both sides.  In float64 (``jax.enable_x64``) the
two agree within 1e-7 relative: the only fp32 values left are constants
both sides round alike (the guided-attention grid).  In fp32 the port is
within 1e-6 relative of JAX plus JAX's own distance from its float64
result: XLA's CPU reduction sums a mean in another order and lands up to
1.4e-6 from the exact mean of 2,048 squares where PyTorch's pairwise sum
lands 6e-8 from it, so no order the port could choose would be closer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config import DEFAULTS_DIR, load_config
from convofusion_tpu.losses import diffvae as jax_losses
from convofusion_tpu.ops.smoothing import laplace_filter_time as jax_laplace
from convofusion_tpu_torch.config import BONES, TINY
from convofusion_tpu_torch.losses import diffvae as losses
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops.smoothing import (
    laplace_filter_time,
    laplacian_1d_kernel,
)

RTOL = 1e-6
RTOL_F64 = 1e-7
B, T, NF = 3, 128, 189


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tree(f, v):
    if isinstance(v, dict):
        return {k: _tree(f, x) for k, x in v.items()}
    if isinstance(v, list):
        return [_tree(f, x) for x in v]
    return f(v) if isinstance(v, np.ndarray) else v


def _check(port_fn, jax_fn, *args, **kw):
    """port_fn and jax_fn on the same numpy args (arrays, dicts of arrays,
    or plain values) in fp32 and in float64, held as the module docstring
    says; outputs an array or a dict of them."""
    out = {}
    for dtype in (np.float32, np.float64):
        conv = (lambda x: x.astype(dtype))
        a, k = _tree(conv, list(args)), _tree(conv, kw)
        with jax.enable_x64(dtype == np.float64):
            want = jax_fn(*_tree(jnp.asarray, a), **_tree(jnp.asarray, k))
            want = _tree(np.asarray, want) if isinstance(want, dict) \
                else np.asarray(want)
        got = port_fn(*_tree(_t, a), **_tree(_t, k))
        out[dtype] = (got, want)
    (g32, w32), (g64, w64) = out[np.float32], out[np.float64]
    if not isinstance(w32, dict):
        g32, w32, g64, w64 = ({"": v} for v in (g32, w32, g64, w64))
    assert set(g32) == set(w32)
    for key in w32:
        a32, b32, a64, b64 = (_np(d[key]) for d in (g32, w32, g64, w64))
        assert a32.shape == b32.shape and a64.dtype == np.float64, key
        scale = max(np.abs(b64).max(), 1e-30)
        assert np.abs(a64 - b64).max() <= RTOL_F64 * scale, key
        jax_own = np.abs(b32 - b64).max()
        assert np.abs(a32 - b32).max() <= RTOL * scale + jax_own, \
            (key, np.abs(a32 - b32).max(), jax_own, scale)


def _laplace(window):
    return lambda v: laplace_filter_time(
        v, torch.from_numpy(laplacian_1d_kernel(window)))


def _pairs(bones=BONES):
    return torch.from_numpy(losses.bone_pairs(bones))


def test_bones_and_handarm_mask_match_jax():
    """``config.BONES`` is assets.yaml's skeleton, as the JAX config system
    loads it; the x5 channel mask is JAX's, and the channel weights are
    root 10, hand/arm 5 (recon) and hand/arm 5 (Laplace), else 1."""
    cfg = load_config(f"{DEFAULTS_DIR}/config_vae_beatdnd.yaml")
    assert [tuple(b) for b in cfg.DATASET.BEATDND.BONES] == list(BONES)
    assert TINY["train"]["bones"] == BONES
    hm = jax_losses._handarm_mask(NF)
    np.testing.assert_array_equal(losses._handarm_mask(NF), hm)
    w = losses.channel_weights(NF)
    np.testing.assert_array_equal(w[1], np.where(hm > 0, 5.0, 1.0))
    np.testing.assert_array_equal(w[0, 3:], w[1, 3:])
    np.testing.assert_array_equal(w[0, :3], [10.0] * 3)


@pytest.mark.parametrize("fn", ["smooth_l1", "kl_divergence_normal"])
def test_elementwise_terms_match_jax(fn):
    a, b = _normal(0, (B, T, NF), 1.5), _normal(1, (B, T, NF), 1.5)
    _check(getattr(losses, fn), getattr(jax_losses, fn), a, b)


@pytest.mark.parametrize("window", [3, 5])
def test_laplace_filter_time_matches_jax(window):
    """A valid conv along time: (B, T - window + 1, F)."""
    x = _normal(2, (B, T, NF))
    got = _laplace(window)(_t(x))
    assert tuple(got.shape) == (B, T - window + 1, NF)
    _check(_laplace(window), lambda v: jax_laplace(v, window), x)


def test_bone_length_variance_matches_jax():
    """Production BONES: ddof 1 over time, bones from joint 0 skipped."""
    x = _normal(3, (B, T, NF), 0.3)
    assert len(losses.bone_pairs(BONES)) == len(BONES) - 3
    _check(lambda v: losses.bone_length_variance(v, _pairs()),
           lambda v: jax_losses.bone_length_variance(v, BONES), x)


def _vae_inputs():
    recon, ref = _normal(4, (B, T, NF), 0.5), _normal(5, (B, T, NF), 0.5)
    mu, logvar = _normal(6, (2, B, 8, 32)), _normal(7, (2, B, 8, 32), 0.3)
    return recon, ref, mu, logvar


@pytest.mark.parametrize("laplace,bones", [(False, False), (True, False),
                                           (True, True)],
                         ids=["rec_kl", "laplace", "laplace_bones"])
def test_vae_losses_match_jax(laplace, bones):
    """Root x10, hand/arm x5 recon, KL, Laplace recon and bone-length
    terms, each and the weighted total."""
    kw = dict(lambda_rec=5.0, lambda_kl=5e-2, lambda_bl=1.0)

    def port(recon, ref, mu, logvar):
        lap = (_laplace(5)(recon), _laplace(5)(ref)) if laplace else ()
        weights = torch.from_numpy(losses.channel_weights(NF))
        return losses.vae_losses(recon, ref, mu, logvar, weights, *lap,
                                 pairs=_pairs() if bones else None, **kw)

    def jax_fn(recon, ref, mu, logvar):
        lap = (jax_laplace(recon, 5), jax_laplace(ref, 5)) if laplace \
            else ()
        return jax_losses.vae_losses(recon, ref, mu, logvar, *lap,
                                     bones=BONES if bones else None, **kw)

    _check(port, jax_fn, *_vae_inputs())


DIFFUSION_CASES = {
    # name: (predict_epsilon, prior, latent, guided attention)
    "epsilon": (True, False, False, False),
    "x0": (False, False, False, False),
    "prior": (True, True, False, False),
    "latent": (True, False, True, False),
    "guided_attention": (True, False, False, True),
    "all": (True, True, True, True),
}


@pytest.mark.parametrize("case", sorted(DIFFUSION_CASES))
def test_diffusion_losses_match_jax(case):
    eps_pred, prior, latent, ga = DIFFUSION_CASES[case]
    h = 4
    pred, noise = _normal(8, (h, 16, 32)), _normal(9, (h, 16, 32))
    kw = {}
    if prior:
        kw.update(noise_pred_prior=_normal(10, (3, 16, 32)),
                  noise_prior=_normal(11, (3, 16, 32)), lambda_prior=0.5)
    if latent:
        kw.update(pred_x0=_normal(12, (h, 16, 32), 2.0),
                  latent_gt=_normal(13, (h, 16, 32)),
                  latent_weights=_rng(14).uniform(1e-3, 1e-2, h).astype(
                      np.float32), lambda_latent=0.1)
    if ga:
        att = {s: _rng(15 + i).dirichlet(np.ones(n), (h, 3, 16)).astype(
            np.float32) for i, (s, n) in enumerate(
                (("alsn", 161), ("tlsn", 16), ("spkemb", 16)))}
        kw.update(att_mats=att, lambda_guided_attention=0.25)
    _check(lambda *a, **k: losses.diffusion_losses(*a, eps_pred, **k),
           lambda *a, **k: jax_losses.diffusion_losses(*a, eps_pred, **k),
           pred, noise, **kw)


def test_guided_attention_loss_matches_jax():
    """alsn and tlsn only, averaged over the layers; a diagonal map costs
    less than a uniform one."""
    att = {s: _rng(20 + i).dirichlet(np.ones(n), (2, 3, 16)).astype(
        np.float32) for i, (s, n) in enumerate((("alsn", 161),
                                                 ("tlsn", 64)))}
    _check(losses.guided_attention_loss, jax_losses.guided_attention_loss,
           att)
    diag = torch.eye(16)[None, None].expand(1, 2, 16, 16)
    flat = torch.full((1, 2, 16, 16), 1 / 16)
    assert losses.guided_attention_loss({"alsn": diag, "tlsn": diag}) < \
        losses.guided_attention_loss({"alsn": flat, "tlsn": flat})


def test_model_reads_its_loss_config():
    """The stage-2 model takes its weights, Laplace window and bones from
    ``cfg['train']`` and keeps the losses' tables as buffers; the stage-1
    config weighs the bone term."""
    m = Convofusion(TINY, device="cpu", seed=None)
    assert m.loss_weights == TINY["train"]["loss"]
    assert torch.equal(m._laplace_kernel,
                       torch.from_numpy(laplacian_1d_kernel(5)))
    assert torch.equal(m._channel_weights,
                       torch.from_numpy(losses.channel_weights(NF)))
    assert torch.equal(m._bone_pairs, _pairs())
    assert m.loss_weights["lambda_bl"] == 0.0
    assert m.guidance_uncondp == 0.1
