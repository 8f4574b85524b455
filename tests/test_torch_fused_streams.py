"""The fused five-stream denoiser layout of the PyTorch port
(``ops/fused_streams.py``, ``FusedDenoiserDecoder``) against the port's
unfused layout and against the JAX package's fused layout.

Weights: the port's seeded unfused denoiser, carried into the fused layout
by ``fuse_denoiser_params`` and into a JAX tree by the JAX package's own
converters (``compat/torch_loader``, ``ops/fused_streams.
fuse_denoiser_params``).  fp32 throughout.  Tolerances: fused against
unfused in the port 1e-5 (the same math in another order: one stacked
LayerNorm and batched GEMMs in place of five); the port against JAX 2e-4,
the bound of JAX's own fused-vs-unfused test (tests/test_fused_streams.py:
44-51); whole samples as tests/test_torch_sampler.py argues (2e-4 + 2e-5
relative).
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
from convofusion_tpu.models.denoiser import Denoiser as JaxDenoiser
from convofusion_tpu.ops import fused_streams as jax_fused
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.denoiser import Denoiser
from convofusion_tpu_torch.ops.fused_streams import (
    fuse_denoiser_params,
    unfuse_denoiser_params,
)
from convofusion_tpu_torch.ops.layers import init_weights
from convofusion_tpu_torch.ops.transformer import COND_STREAMS
from convofusion_tpu_torch.train import checkpoint as ck
from test_torch_sampler import ATOL, RTOL, _jax_noise_sequence
from test_torch_train import jax_params_from_port

D, LAT, B, STEPS = 64, 32, 2, 3
PORT_TOL = 1e-5
JAX_TOL = 2e-4
SIZES = dict(spkemb=9, alsn=12, tlsn=7, apb=8, lsnemb=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _denoiser(fuse, seed=0):
    den = Denoiser(latent_dim=LAT, **{**TINY["denoiser"],
                                      "fuse_streams": fuse})
    if seed is not None:
        init_weights(den, torch.Generator().manual_seed(seed))
    return den.eval()


def _inputs(rng, b=B):
    sample = rng.standard_normal((b, 16, LAT)).astype(np.float32)
    cond = {s: rng.standard_normal((b, SIZES[s], D)).astype(np.float32)
            for s in COND_STREAMS}
    pad = np.zeros((b, SIZES["tlsn"]), bool)
    pad[0, 5:] = True
    return sample, cond, {"tlsn": pad}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def pair():
    """The seeded unfused denoiser and the fused one through the
    converter."""
    unfused = _denoiser(False)
    fused = _denoiser(True, seed=None)
    fused.load_state_dict(fuse_denoiser_params(unfused.state_dict()))
    return unfused, fused


def test_converters_are_inverse(pair):
    unfused, fused = pair
    sd = unfused.state_dict()
    back = unfuse_denoiser_params(fuse_denoiser_params(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    names = set(fused.state_dict())
    assert {f"decoder.layers.0.cross_streams.{n}" for n in (
        "ln_scale", "ln_bias", "q_kernel", "o_bias")} <= names
    assert not any("multihead_attn_" in k for k in names)


@pytest.mark.parametrize("single_rows", [False, True],
                         ids=["batch_rows", "shared_uncond_rows"])
def test_fused_denoiser_matches_unfused(pair, single_rows):
    """Output and per-stream attention maps, at a (B,) timestep; with
    ``single_rows`` the WEG text-only pass's inputs: a scalar timestep and
    four streams as shared (1, Tk, D) rows with a (1, Tk) mask, which the
    fused stack broadcasts."""
    unfused, fused = pair
    sample, cond, masks = _inputs(np.random.default_rng(1))
    t = torch.tensor([500, 20])
    if single_rows:
        cond = {s: v[:1] if s != "tlsn" else v for s, v in cond.items()}
        masks = {"tlsn": masks["tlsn"], "spkemb": np.zeros((1, 9), bool)}
        t = 500
    args = (torch.from_numpy(sample), t, _t(cond), _t(masks))
    with torch.no_grad():
        if single_rows:
            (want, att_u), (got, att_f) = (unfused.text_only(*args),
                                           fused.text_only(*args))
        else:
            (want, att_u), (got, att_f) = unfused(*args), fused(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PORT_TOL,
                               rtol=0)
    assert set(att_f) == set(att_u)
    for s in COND_STREAMS:
        assert att_f[s].shape == (B, 3, 16, SIZES[s]), s
        np.testing.assert_allclose(att_f[s].numpy(),
                                   att_u[s].expand_as(att_f[s]).numpy(),
                                   atol=PORT_TOL, rtol=0, err_msg=s)


def test_fused_denoiser_matches_jax(pair):
    """The port's fused denoiser against JAX's ``Denoiser(fuse_streams=
    True)`` on JAX's fused tree of the same weights (unfused tree by
    ``torch_loader``, fused by JAX's converter)."""
    unfused, fused = pair
    sd = {k: v.numpy() for k, v in unfused.state_dict().items()}
    params = jax_fused.fuse_denoiser_params(tl.denoiser_params(sd, D, 3))
    jd = JaxDenoiser(nfeats=189, latent_dim=LAT, ff_size=64, num_layers=3,
                     num_heads=4, dropout=0.0, text_encoded_dim=D,
                     audio_encoded_dim=D, fuse_streams=True)
    sample, cond, masks = _inputs(np.random.default_rng(2))
    want, att_j = jax.jit(lambda p: jd.apply({"params": p}, sample, 500,
                                             cond, masks))(params)
    with torch.no_grad():
        got, att_t = fused(torch.from_numpy(sample), 500, _t(cond),
                           _t(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_TOL,
                               rtol=JAX_TOL)
    for s in COND_STREAMS:
        np.testing.assert_allclose(att_t[s].numpy(), np.asarray(att_j[s]),
                                   atol=JAX_TOL, rtol=JAX_TOL, err_msg=s)


@pytest.fixture(scope="module")
def models():
    """Unfused and fused TINY models at DDIM-3 on the same weights, the
    fused one loaded from JAX's fused tree through ``state_dict_from_jax``
    (which must carry ``cross_streams``)."""
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=STEPS)
    unfused = Convofusion(cfg, device="cpu", seed=0)
    params = jax_params_from_port(unfused)
    params["denoiser"] = jax_fused.fuse_denoiser_params(params["denoiser"])
    fcfg = copy.deepcopy(cfg)
    fcfg["denoiser"]["fuse_streams"] = True
    fused = Convofusion(fcfg, device="cpu", seed=None)
    sd = state_dict_from_jax(params)
    port_sd = fuse_denoiser_params(unfused.state_dict())
    assert set(sd) == set(port_sd)
    for k in sd:
        torch.testing.assert_close(sd[k], port_sd[k].float(), rtol=0,
                                   atol=0, msg=k)
    fused.load_state_dict(sd)
    return unfused, fused, params


def test_fused_sample_matches_jax(models, monkeypatch):
    """A guided DDIM-3 ``sample()`` of the fused model against JAX's fused
    ``sample`` on the same tree and JAX's noise: the tiled 7B step (JAX
    :828-840), and no step kernel on either side (JAX's gate :640-649)."""
    _, fused, params = models
    cfg = tiny_config("diffusion")
    cfg.model.denoiser.params.fuse_streams = True
    cfg.model.scheduler["variant"] = "ddim"
    jm = JaxConvofusion(cfg)
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(fused, raw)
    key = jax.random.PRNGKey(4)
    motion_j, lat_j, att_j = jax.jit(lambda p, b, k: jm.sample(
        p, b, k, num_inference_steps=STEPS, capture_attention="all"))(
        params, jb, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, LAT))
    calls = []
    monkeypatch.setattr(port, "guided_step",
                        lambda *a: calls.append(a) or None)
    assert not fused.uses_step_kernel()
    motion, lat, att = fused.sample(
        tb, num_inference_steps=STEPS, init_noise=torch.from_numpy(init),
        step_noise=torch.from_numpy(steps), capture_attention="all")
    assert calls == []
    np.testing.assert_allclose(lat.numpy(), np.asarray(lat_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(motion.numpy(), np.asarray(motion_j),
                               atol=ATOL, rtol=RTOL)
    for s in COND_STREAMS:
        assert tuple(att[s].shape) == np.asarray(att_j[s]).shape, s
        np.testing.assert_allclose(att[s].numpy(), np.asarray(att_j[s]),
                                   atol=JAX_TOL, rtol=0, err_msg=s)


def test_fused_weg_matches_unfused(models):
    """WEG's text-only pass on the fused layout goes through the plain
    forward (JAX :724-728) over the shared single uncond rows; the
    refinement is forced at step 0.  JAX's fused stack cannot stack those
    rows' (1, Tk) masks beside (B, Tk) ones (``pad_stream_stack`` raises
    'All input arrays must have the same shape'); the port broadcasts them,
    and matches its unfused WEG sample, which tests/test_torch_weg.py holds
    to JAX."""
    unfused, fused, _ = models
    raw = jax_synthetic.synthetic_raw_batch(5, B)
    tb, _, _ = torch_synthetic.prepare_arrays(unfused, raw)
    rng = np.random.default_rng(6)
    init = torch.from_numpy(rng.standard_normal((B, 16, LAT)).astype(
        np.float32))
    steps = torch.from_numpy(rng.standard_normal((STEPS, B, 16, LAT)).astype(
        np.float32))
    focus = {"focus_idx": np.array([[1, 2], [1, 0]], np.int32),
             "focus_valid": np.array([[True, True], [True, False]])}
    wp = {"thresholds": {0: 0.99}, "max_refinement_steps": 2}
    out = {}
    for name, m in (("unfused", unfused), ("fused", fused)):
        m.weg_counts = port.WegCounts()
        out[name] = m.sample(tb, num_inference_steps=STEPS, init_noise=init,
                             step_noise=steps, focus=focus, weg_params=wp)
        out[name] += (m.weg_counts,)
    assert out["fused"][2] == out["unfused"][2]
    assert out["fused"][2].refinement_iterations == 2
    np.testing.assert_allclose(out["fused"][1].numpy(),
                               out["unfused"][1].numpy(), atol=ATOL,
                               rtol=RTOL)


def test_fused_layout_refuses_the_per_stream_paths(models, tmp_path):
    """``guided`` needs per-stream layers (JAX asserts);
    an unfused checkpoint does not load into a fused model (JAX makes no
    conversion either), and a fused one round-trips."""
    unfused, fused, _ = models
    with pytest.raises(NotImplementedError, match="fuse_streams"):
        fused.denoiser.guided(torch.zeros(1, 16, LAT), 5, {}, {})
    path = ck.save_checkpoint(str(tmp_path / "u"), 0, unfused)
    with pytest.raises(KeyError, match="does not fit"):
        ck.load_torch_full_model(path, fused)
    with pytest.raises(KeyError, match="does not fit"):
        ck.load_checkpoint(path, fused)
    path = ck.save_checkpoint(str(tmp_path / "f"), 0, fused)
    again = Convofusion(fused.cfg, device="cpu", seed=1)
    ck.load_checkpoint(path, again)
    for k, v in fused.state_dict().items():
        if not k.startswith(ck.TRUNK):
            assert torch.equal(again.state_dict()[k], v), k
