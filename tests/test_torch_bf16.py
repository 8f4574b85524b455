"""The bf16 port against the JAX package's bf16, at the tiny geometry.

JAX: ``tiny_config('diffusion')`` with ``compute_dtype = 'bfloat16'`` on the
denoiser, the motion VAE and the text and audio encoders, as ``bench.py``
sets it.  Port: ``Convofusion(TINY, dtype='bfloat16')``.  Both carry the
same fp32 weights (JAX ``init_params`` through ``state_dict_from_jax``) and
see the same synthetic batch and latents.

bf16 keeps 8 significant bits: one rounding moves a value by up to half an
ulp, 2^-8 of its binade at most.  XLA fuses ops and keeps some
intermediates in fp32 where eager PyTorch rounds each op's output, so the
two sides round at different places and differ by a few ulps, not by
0.  Each tolerance below is stated in ulps of the largest magnitude it
compares, with what was observed.  A cast in another place than JAX's (a
stream kept in bf16 that JAX keeps in fp32) shows as a dtype that differs
or as a port further from fp32 than JAX is.  Only one denoiser call and one
step are compared: rounding compounds through 50 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.diffusion.schedulers import DiffusionScheduler
from convofusion_tpu.models import weg as jax_weg
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.ops.pallas_step import fused_guided_step
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import weg
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops.guided_step import guided_step

B, T, LAT = 3, 16, 32
TIMESTEP = 620
BATCH_KEYS = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
              "active_passive_lsn", "lsn_id")
# conditions: within 2 ulps of each stream's largest magnitude (observed
# at most 1: the encoders are short and round alike)
COND_ULPS = 2
# planes (|x| <= 3.5): within 8 ulps (0.125) at most and 1 ulp (2^-6)
# on average; observed 2 ulps (0.031) and 0.0055 over 3 bf16 layers
PLANE_ULPS, PLANE_MEAN_ULPS = 8, 1
# the port's mean distance from the fp32 port is JAX's within 25%
# (observed 0.99x): no extra rounding step in the port
FP32_DISTANCE_RATIO = 1.25
# one step on the same bf16 planes: fp32 arithmetic, as in
# tests/test_torch_guided_step.py
STEP_TOL = 2e-5
# the WEG loss (|loss| ~ 0.88): within 1 ulp at its magnitude; observed
# 0.11 (4.3e-4).  The per-token terms 1 - max_att are bf16 on both sides,
# but XLA keeps them in fp32 inside its fusion where the port rounds them
# (max_att itself differed by at most 1 ulp)
WEG_LOSS_ULPS = 1
# its gradient w.r.t. the fp32 latents, in ulps of max |grad|: the
# softmax, smoothing and max run in bf16, so JAX's own bf16 gradient is
# 55 ulps from the fp32 port's at most.  Observed against JAX: 56 ulps at
# most, 2.6 on average; the port's mean distance from the fp32 port is
# 0.55x JAX's (within FP32_DISTANCE_RATIO)
WEG_GRAD_ULPS, WEG_GRAD_MEAN_ULPS = 128, 4
ACP = DiffusionScheduler().alphas_cumprod
STEP_CASES = {
    # name: (alpha_t, alpha_prev, is_ddpm, add_noise)
    "ddim": (ACP[500], ACP[480], 0.0, 1.0),
    "ddpm_mid": (ACP[500], ACP[480], 1.0, 1.0),
    "ddpm_final": (ACP[0], 1.0, 1.0, 0.0),
}


def _ulp(x) -> float:
    """A bf16 ulp at the largest magnitude of x."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _np(x):
    """JAX or torch array -> fp32 numpy (bf16 values are exact in fp32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(tree):
    """JAX conditions or masks -> torch, keeping bf16 as bf16."""
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.array(_np(v) if v.dtype == jnp.bfloat16
                                      else v))
        out[k] = t.bfloat16() if v.dtype == jnp.bfloat16 else t
    return out


@pytest.fixture(scope="module")
def twins():
    cfg = tiny_config("diffusion")
    for block in ("denoiser", "motion_vae", "text_encoder", "audio_encoder"):
        cfg.model[block].params["compute_dtype"] = "bfloat16"
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    ports = {}
    for dtype in ("bfloat16", "float32"):
        ports[dtype] = Convofusion(TINY, dtype=dtype, device="cpu", seed=None)
        ports[dtype].load_state_dict(state_dict_from_jax(params))
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(ports["bfloat16"], raw)
    return jm, params, ports, jbatch, tbatch


@pytest.fixture(scope="module")
def planes(twins):
    """One guided denoiser call on each side, on JAX's conditions, and the
    fp32 port's on the same conditions upcast."""
    jm, params, ports, jbatch, _ = twins
    cond, masks = jm.encode_conditions(params, *(jbatch[k]
                                                 for k in BATCH_KEYS))
    cond_u, masks_u = jm.encode_uncond(params, jbatch)
    latents = np.random.default_rng(0).standard_normal(
        (B, T, LAT)).astype(np.float32)
    np_j, _ = jm.denoiser.apply(
        {"params": params["denoiser"]}, jnp.asarray(latents),
        jnp.asarray(TIMESTEP), cond, cond_u, masks, masks_u,
        method=jm.denoiser.guided)
    tc, tm, tcu, tmu = (_torch(d) for d in (cond, masks, cond_u, masks_u))
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in tc.items()}
    f32_u = {k: (v.float() if v.is_floating_point() else v)
             for k, v in tcu.items()}
    with torch.no_grad():
        np_t, _ = ports["bfloat16"].denoiser.guided(
            torch.from_numpy(latents), TIMESTEP, tc, tcu, tm, tmu)
        np_f32, _ = ports["float32"].denoiser.guided(
            torch.from_numpy(latents), TIMESTEP, f32, f32_u, tm, tmu)
    return latents, np_j, np_t, np_f32


def test_conditions_match_jax_bf16(twins):
    """encode_conditions and encode_uncond: each stream in JAX's dtype
    (text and audio in bf16, the fuser's embedding rows in fp32, as the
    JAX model builds its fuser without a compute dtype) and within
    COND_ULPS."""
    jm, params, ports, jbatch, tbatch = twins
    port = ports["bfloat16"]
    want = (jm.encode_conditions(params, *(jbatch[k] for k in BATCH_KEYS))[0],
            jm.encode_uncond(params, jbatch)[0])
    with torch.no_grad():
        got = (port.encode_conditions(*(tbatch[k] for k in BATCH_KEYS))[0],
               port.encode_uncond(tbatch)[0])
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for s in w:
            assert str(g[s].dtype).split(".")[-1] == str(w[s].dtype), s
            a, b = _np(w[s]), _np(g[s])
            assert a.shape == b.shape, s
            assert np.abs(a - b).max() <= COND_ULPS * _ulp(a), s


def test_guided_planes_match_jax_bf16(planes):
    """Denoiser.guided: the (7, B, 16, 32) bf16 planes."""
    _, np_j, np_t, np_f32 = planes
    assert np_j.dtype == jnp.bfloat16 and np_t.dtype == torch.bfloat16
    assert np_t.shape == (7, B, T, LAT)
    a, b, ref = _np(np_j), _np(np_t), np_f32.numpy()
    diff = np.abs(a - b)
    assert diff.max() <= PLANE_ULPS * _ulp(a)
    assert diff.mean() <= PLANE_MEAN_ULPS * _ulp(a)
    assert np.abs(b - ref).mean() <= \
        FP32_DISTANCE_RATIO * np.abs(a - ref).mean()


def _lipschitz(a_t, a_prev, is_ddpm, gs):
    """Largest change of the step's output per unit change of any branch
    plane (max norm): the combine weighs u by |1 - 5 gs| and each of
    b1..b5 by gs; x0 scales eps by sqrt(1 - a_t) / sqrt(a_t) (the clip
    only shrinks a change); the update then scales x0."""
    combine = abs(1.0 - 5.0 * gs) + 5.0 * gs
    x0 = np.sqrt(1.0 - a_t) / np.sqrt(a_t) * combine
    if is_ddpm:
        return np.sqrt(a_prev) * (1.0 - a_t / a_prev) / (1.0 - a_t) * x0
    return abs(np.sqrt(a_prev)
               - np.sqrt(1.0 - a_prev) * np.sqrt(a_t) / np.sqrt(1.0 - a_t)
               ) * x0


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_on_bf16_planes_matches_pallas(planes, case):
    """guided_step (its CPU version) on bf16 planes against the Pallas
    kernel in interpret mode: on JAX's planes within STEP_TOL; on each
    side's own planes within what the planes' difference can move the
    output (the step's Lipschitz bound) plus STEP_TOL."""
    latents, np_j, np_t, _ = planes
    a_t, a_prev, is_ddpm, add_noise = STEP_CASES[case]
    gs = float(TINY["guidance_scale"])
    noise = np.random.default_rng(1).standard_normal(
        latents.shape).astype(np.float32)
    scalars = (float(a_t), float(a_prev), gs, is_ddpm, add_noise, 1.0)
    want = np.asarray(fused_guided_step(
        np_j, jnp.asarray(latents), jnp.asarray(noise),
        *map(jnp.float32, scalars), interpret=True))
    lat, z = torch.from_numpy(latents), torch.from_numpy(noise)
    same = guided_step(_torch({"p": np_j})["p"], lat, z, *scalars)
    np.testing.assert_allclose(same.numpy(), want, rtol=0, atol=STEP_TOL)
    own = guided_step(np_t, lat, z, *scalars)
    delta = np.abs(_np(np_j) - _np(np_t)).max()
    bound = _lipschitz(float(a_t), float(a_prev), is_ddpm, gs) * delta
    assert np.abs(own.numpy() - want).max() <= bound + STEP_TOL


def test_weg_loss_and_grad_match_jax_bf16(twins):
    """The WEG loss of the bf16 text-only pass and its gradient w.r.t. the
    fp32 latents against jax.value_and_grad on JAX's bf16 model, on JAX's
    conditions: the tlsn attention stays bf16 through the layer mean,
    softmax, smoothing and max on both sides; the loss and the gradient
    are fp32."""
    jm, params, ports, jbatch, _ = twins
    cond, masks = jm.encode_conditions(params, *(jbatch[k]
                                                 for k in BATCH_KEYS))
    cond_u, masks_u = jm.encode_uncond(params, jbatch)
    cond_t = {s: cond[s] if s == "tlsn" else cond_u[s] for s in cond}
    masks_t = {s: masks[s] if s == "tlsn" else masks_u[s] for s in masks}
    pad = masks["tlsn"]
    eot = jnp.where(jnp.any(pad, axis=1),
                    jnp.argmax(pad.astype(jnp.int32), axis=1) - 1,
                    pad.shape[1] - 1)
    # interior, boundary (column 1) and repeated focus columns
    fi = np.asarray([[1, 3, 0], [2, 4, 1], [1, 2, 3]], np.int32)
    fv = np.asarray([[1, 1, 0], [1, 1, 1], [1, 0, 0]], np.float32)
    latents = np.random.default_rng(5).standard_normal(
        (B, T, LAT)).astype(np.float32)

    def jax_att(lat, t):
        _, att = jm.denoiser.apply({"params": params["denoiser"]}, lat, t,
                                   cond_t, masks_t,
                                   method=jm.denoiser.text_only)
        assert att["tlsn"].dtype == jnp.bfloat16
        return att["tlsn"]

    loss_j, grad_j = jax.value_and_grad(jax_weg.make_weg_loss(
        jax_att, jnp.asarray(fi), jnp.asarray(fv), eot))(
        jnp.asarray(latents), jnp.asarray(TIMESTEP))

    def port_loss_grad(dtype):
        tc, tm = _torch(cond_t), _torch(masks_t)
        if dtype == "float32":
            tc = {k: v.float() for k, v in tc.items()}

        def att(lat, t):
            out = ports[dtype].denoiser.text_only(lat, t, tc, tm)[1]["tlsn"]
            assert out.dtype == getattr(torch, dtype)
            return out

        with torch.no_grad():
            return weg.value_and_grad(weg.make_weg_loss(
                att, torch.from_numpy(fi), torch.from_numpy(fv),
                torch.from_numpy(np.array(eot))))(
                torch.from_numpy(latents), TIMESTEP)

    loss_t, grad_t = port_loss_grad("bfloat16")
    _, grad_f32 = port_loss_grad("float32")
    assert loss_t.dtype == grad_t.dtype == torch.float32
    assert abs(float(loss_t) - float(loss_j)) <= \
        WEG_LOSS_ULPS * _ulp(np.asarray(loss_j))
    a, b, ref = np.asarray(grad_j), grad_t.numpy(), grad_f32.numpy()
    diff = np.abs(a - b)
    assert diff.max() <= WEG_GRAD_ULPS * _ulp(a)
    assert diff.mean() <= WEG_GRAD_MEAN_ULPS * _ulp(a)
    assert np.abs(b - ref).mean() <= \
        FP32_DISTANCE_RATIO * np.abs(a - ref).mean()
