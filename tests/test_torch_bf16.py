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
or as a port further from fp32 than JAX is.  One denoiser call, one step,
one DPM-Solver++ step, one DDIM-4 window with a preseq and one stage-2
training loss with its gradients are compared: rounding compounds through
50 steps.  The last case holds the trainer's fp32 master weights to what
they are for: keeping updates smaller than bf16's spacing.
"""
import dataclasses

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
from convofusion_tpu.train.trainer import Trainer as JaxTrainer
from convofusion_tpu.ops.pallas_step import fused_guided_step
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import weg
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.diffusion.schedulers import (
    DiffusionScheduler as PortScheduler,
)
from convofusion_tpu_torch.ops.guided_step import guided_step
from convofusion_tpu_torch.train.trainer import Trainer, trainable_parameters
from test_torch_train import (
    diffusion_draws,
    jax_params_from_port,
    port_config,
)

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
# a DDIM-4 window with a preseq: x0 clipping turns a bf16 rounding into
# a jump of up to 2 once a value sits at the clip, so values are compared by
# their mean.  The port's mean distance from the fp32 port is JAX's within
# WINDOW_DISTANCE_RATIO (observed 1.16x on the latents, 1.13x on the
# motion); the mean |port - JAX| stays within WINDOW_MEAN_RATIO of JAX's
# own mean distance from fp32 (observed 1.39x and 1.46x)
WINDOW_DISTANCE_RATIO, WINDOW_MEAN_RATIO = 1.5, 2.0
# a stage-2 training loss (|loss| ~ 1.8, fp32 from bf16 predictions):
# within 1 ulp of JAX's (observed 0.035); its gradients, in fractions of
# each tensor's max |fp32 gradient|: max |port - JAX| within
# TRAIN_GRAD_MAX (observed 0.095, on the attention and audio biases, whose
# gradient sums every row), the port's mean distance from the fp32 port
# within FP32_DISTANCE_RATIO of JAX's summed over the tensors (observed
# 0.65x) and within TRAIN_GRAD_TENSOR_RATIO of it in each (observed 1.31x)
TRAIN_LOSS_ULPS = 1
TRAIN_GRAD_MAX, TRAIN_GRAD_TENSOR_RATIO = 0.125, 2.0
# a whole DDIM-50 sample: as the window, by mean distances (observed
# 1.15x and 1.27x on the latents, 1.14x and 1.10x on the motion)
SAMPLE_STEPS = 50
SAMPLE_DISTANCE_RATIO, SAMPLE_MEAN_RATIO = 1.5, 2.0
# three AdamW steps: every loss within TRAIN_LOSS_ULPS of JAX's (observed
# 0.04, 0.29, 0.46 ulps).  An update moves a weight by at most 1.0035 lr
# in the first three steps (|m_hat / sqrt(v_hat)| by Cauchy-Schwarz at
# betas 0.9 / 0.999, weight decay 1e-2 adds ~1e-2 |w| lr), so masters and
# JAX's parameters, started equal, part by at most ~6.02 lr where
# near-zero gradients take opposite signs (observed 5.9 lr); the mean
# distance is the measure: the port's masters from the fp32 port's within
# FP32_DISTANCE_RATIO of JAX's (observed 0.94x)
MASTER_MAX_LRS = 6.1
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


@pytest.mark.parametrize("t,prev_t,first", [(950, 900, True),
                                            (500, 450, False),
                                            (0, -50, False)],
                         ids=["first", "middle", "final"])
def test_dpmpp_step_on_bf16_planes_matches_jax(twins, planes, t, prev_t,
                                               first):
    """The dpmpp path's plain combine (bf16 on both sides, as JAX keeps
    the planes' dtype) and dpmpp_2m_step (fp32) on JAX's bf16 planes:
    within STEP_TOL (observed 0)."""
    jm, _, ports, _, _ = twins
    latents, np_j, _, _ = planes
    port = ports["bfloat16"]
    eps_j = jm.guidance_combine_branches(np_j)
    eps_t = port.guidance_combine_branches(_torch({"p": np_j})["p"])
    assert eps_j.dtype == jnp.bfloat16 and eps_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(eps_t), _np(eps_j))
    prev_d = np.random.default_rng(2).uniform(
        -1, 1, latents.shape).astype(np.float32)
    js, ps = (DiffusionScheduler(variant="dpmpp_2m"),
              PortScheduler(variant="dpmpp_2m"))
    lam_prev = float(ps._lambda(torch.tensor(ACP[min(t + 50, 999)])))
    want = js.dpmpp_2m_step(eps_j, t, prev_t, jnp.asarray(latents),
                            jnp.asarray(prev_d), jnp.float32(lam_prev),
                            first)
    got = ps.dpmpp_2m_step(eps_t, t, prev_t, torch.from_numpy(latents),
                           torch.from_numpy(prev_d), lam_prev, first)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STEP_TOL)


def test_preseq_window_matches_jax_bf16(twins):
    """A DDIM-4 rollout window with a preseq in bf16 on both sides, JAX's
    noise replayed, the fp32 port on the same inputs as the reference."""
    jm, params, ports, jbatch, tbatch = twins
    cfg = tiny_config("diffusion")
    for block in ("denoiser", "motion_vae", "text_encoder",
                  "audio_encoder"):
        cfg.model[block].params["compute_dtype"] = "bfloat16"
    cfg.model.scheduler["variant"] = "ddim"
    jm = JaxConvofusion(cfg)
    preseq = np.random.default_rng(6).standard_normal(
        (B, 8, LAT)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(4)
    motion_j, lat_j, _ = jax.jit(lambda p, b, k, ps: jm.sample(
        p, b, k, num_inference_steps=4, preseq=ps))(
        params, jbatch, key, jnp.asarray(preseq))
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, (B, T, LAT)))
    steps = []
    for _ in range(4):
        k, k_step = jax.random.split(k)
        steps.append(np.array(jax.random.normal(k_step, (B, T, LAT))))
    out = {}
    for dtype, port in ports.items():
        saved = port.scheduler
        port.scheduler = dataclasses.replace(saved, variant="ddim")
        try:
            out[dtype] = port.sample(
                tbatch, num_inference_steps=4,
                init_noise=torch.from_numpy(init),
                step_noise=torch.from_numpy(np.stack(steps)),
                preseq=torch.from_numpy(preseq))
        finally:
            port.scheduler = saved
    for i, want in ((1, lat_j), (0, motion_j)):
        a, b, ref = _np(want), _np(out["bfloat16"][i]), _np(
            out["float32"][i])
        assert np.isfinite(b).all() and b.shape == a.shape
        jax_dist = np.abs(a - ref).mean()
        assert np.abs(b - ref).mean() <= WINDOW_DISTANCE_RATIO * jax_dist
        assert np.abs(a - b).mean() <= WINDOW_MEAN_RATIO * jax_dist


def _stage2_grads(model, batch, draws):
    """The stage-2 loss and the trainable gradients in fp32, with the
    model in eval mode (its audio dropout off) and grads enabled."""
    params = [p for _, p in trainable_parameters(model, "diffusion")]
    for p in params:
        p.requires_grad_(True)
    try:
        loss, _ = model.train_diffusion_loss(batch, None, draws)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float() for n, p in
                             model.named_parameters() if p.grad is not None}
    finally:
        for p in params:
            p.requires_grad_(False)
            p.grad = None


def test_training_loss_and_grads_match_jax_bf16(twins):
    """train_diffusion_loss in bf16 on both sides, on JAX's draws: JAX's
    fp32 parameters cast at each use against the port's bf16 weights."""
    _, params, ports, jbatch, tbatch = twins
    cfg = tiny_config("diffusion")
    for block in ("denoiser", "motion_vae", "text_encoder", "audio_encoder"):
        cfg.model[block].params["compute_dtype"] = "bfloat16"
    jm = JaxConvofusion(cfg)
    jm.audio_encoder = jm.audio_encoder.clone(dropout=0.0)
    key = jax.random.PRNGKey(9)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jm.train_diffusion_loss(p, jbatch, key), has_aux=True))(
        params)
    want = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads_j))
    draws = diffusion_draws(jm, key, B)
    loss_t, grads_t = _stage2_grads(ports["bfloat16"], tbatch, draws)
    loss_f, grads_f = _stage2_grads(ports["float32"], tbatch, draws)
    loss_j = float(loss_j)
    assert abs(loss_t - loss_j) <= TRAIN_LOSS_ULPS * _ulp(np.asarray(loss_j))
    assert abs(loss_t - loss_f) <= FP32_DISTANCE_RATIO * abs(loss_j - loss_f)
    assert set(grads_t) == set(grads_f)
    port_dist = jax_dist = 0.0
    for name, ref in grads_f.items():
        a, b, r = want[name].numpy(), grads_t[name].numpy(), ref.numpy()
        scale = np.abs(r).max()
        assert np.abs(a - b).max() <= TRAIN_GRAD_MAX * scale, name
        dj, dp = np.abs(a - r).mean(), np.abs(b - r).mean()
        assert dp <= TRAIN_GRAD_TENSOR_RATIO * dj, name
        port_dist, jax_dist = port_dist + dp / scale, jax_dist + dj / scale
    assert port_dist <= FP32_DISTANCE_RATIO * jax_dist


def test_fp32_master_keeps_updates_below_bf16_spacing():
    """A constant gradient makes every AdamW update ~-lr = -7e-5; a bf16
    weight in [2^-4, 2^-3) has spacing 2^-11 (4.9e-4), so stepped in bf16
    it would never move.  The fp32 master moves at the first step and,
    some steps later, carries the bf16 weight across a rounding
    boundary."""
    model = Convofusion(TINY, dtype="bfloat16", device="cpu", seed=1)
    trainer = Trainer(model)
    trainer.init_state()
    weight = model.denoiser.latent_proj.weight
    idx = next(i for i, p in enumerate(trainer.params) if p is weight)
    start = weight.detach().clone()
    big = (start.float().abs() >= 2 ** -4) & (start.float().abs() < 2 ** -3)
    assert int(big.sum()) > 10
    lr = TINY["train"]["optim"]["lr"]
    lone_bf16 = start + torch.tensor(-lr, dtype=torch.bfloat16)
    assert torch.equal(lone_bf16[big], start[big])

    def step():
        with trainer.training():
            for p in trainer.params:
                p.grad = torch.ones_like(p)
            trainer.apply_grads()

    step()
    master = trainer.masters[idx]
    assert master.dtype == torch.float32
    assert torch.equal(weight[big], start[big])
    assert bool((master[big] < start.float()[big]).all())
    for _ in range(9):
        step()
    assert torch.equal(weight, master.to(torch.bfloat16))
    moved = weight[big] != start[big]
    assert float(moved.float().mean()) > 0.5


def _bf16_jax_model(variant=None, audio_dropout=None):
    cfg = tiny_config("diffusion")
    for block in ("denoiser", "motion_vae", "text_encoder", "audio_encoder"):
        cfg.model[block].params["compute_dtype"] = "bfloat16"
    if variant:
        cfg.model.scheduler["variant"] = variant
    jm = JaxConvofusion(cfg)
    if audio_dropout is not None:
        jm.audio_encoder = jm.audio_encoder.clone(dropout=audio_dropout)
    return jm


def test_sample_50_steps_matches_jax_bf16(twins):
    """A whole DDIM-50 sample() in bf16 on both sides (the step kernel's
    path: JAX's Pallas kernel in interpret mode, the port's plain
    version), JAX's noise replayed, the fp32 port on the same inputs as
    the reference.  Rounding compounds over 50 steps and x0 clipping
    turns it into jumps, so values are compared by their mean distance."""
    _, params, ports, jbatch, tbatch = twins
    jm = _bf16_jax_model("ddim")
    key = jax.random.PRNGKey(12)
    motion_j, lat_j, _ = jax.jit(lambda p, b, k: jm.sample(
        p, b, k, num_inference_steps=SAMPLE_STEPS))(params, jbatch, key)
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, (B, T, LAT)))
    steps = []
    for _ in range(SAMPLE_STEPS):
        k, k_step = jax.random.split(k)
        steps.append(np.array(jax.random.normal(k_step, (B, T, LAT))))
    out = {}
    for dtype, port in ports.items():
        saved = port.scheduler
        port.scheduler = dataclasses.replace(saved, variant="ddim")
        try:
            out[dtype] = port.sample(
                tbatch, num_inference_steps=SAMPLE_STEPS,
                init_noise=torch.from_numpy(init),
                step_noise=torch.from_numpy(np.stack(steps)))
        finally:
            port.scheduler = saved
    for i, want in ((1, lat_j), (0, motion_j)):
        a, b, ref = _np(want), _np(out["bfloat16"][i]), _np(
            out["float32"][i])
        assert np.isfinite(b).all() and b.shape == a.shape
        jax_dist = np.abs(a - ref).mean()
        assert np.abs(b - ref).mean() <= SAMPLE_DISTANCE_RATIO * jax_dist
        assert np.abs(a - b).mean() <= SAMPLE_MEAN_RATIO * jax_dist


def test_three_training_steps_match_jax_bf16():
    """Three stage-2 AdamW steps in bf16 on both sides, on JAX's key
    splits: JAX keeps fp32 parameters and casts them at each use, the port
    keeps bf16 weights with fp32 masters, which start from the same fp32
    weights (``init_state(weights)``: started from their bf16 rounding,
    the port's step-2 loss was 1.9560 against JAX's 1.9090).  The losses,
    and the masters against JAX's parameters after the three steps,
    measured against the fp32 port's run on the same draws."""
    b = 6
    f32 = Convofusion(port_config(), device="cpu", seed=2)
    params = jax_params_from_port(f32)
    sd = f32.state_dict()
    bf16 = Convofusion(port_config(), dtype="bfloat16", device="cpu",
                       seed=None)
    bf16.load_state_dict(sd)
    jm = _bf16_jax_model(audio_dropout=0.0)
    raws = [jax_synthetic.synthetic_raw_batch(40 + i, b) for i in range(3)]
    jbs = [jax_synthetic.prepare_arrays(jm, r)[0] for r in raws]
    jt = JaxTrainer(jm, jm.cfg)
    key = jax.random.PRNGKey(13)
    params_j, _, loss_j = jt.fit_steps(params, jt.optimizer.init(params),
                                       jbs, key, log_every=1)
    draws, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        draws.append(diffusion_draws(jm, sub, b))
    runs = {}
    for name, model in (("bfloat16", bf16), ("float32", f32)):
        tbs = [torch_synthetic.prepare_arrays(model, r)[0] for r in raws]
        trainer = Trainer(model)
        trainer.init_state(sd)
        losses = trainer.fit_steps(tbs, None, log_every=1, draws=draws)
        runs[name] = (losses, trainer)
    loss_b, trainer_b = runs["bfloat16"]
    loss_f, trainer_f = runs["float32"]
    assert all(m.dtype == torch.float32 for m in trainer_b.masters)
    for lj, lb, lf in zip(loss_j, loss_b, loss_f):
        assert abs(lb - lj) <= TRAIN_LOSS_ULPS * _ulp(np.asarray(lj))
        assert abs(lb - lf) <= FP32_DISTANCE_RATIO * abs(lj - lf) + \
            TRAIN_LOSS_ULPS * _ulp(np.asarray(lj))
    want = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), params_j))
    names = [n for n, _ in trainable_parameters(bf16, "diffusion")]
    masters_b = dict(zip(names, trainer_b.masters))
    masters_f = dict(zip(names, trainer_f.masters))
    port_dist = jax_dist = 0.0
    worst = 0.0
    for n in names:
        a, m, r = want[n].numpy(), masters_b[n].numpy(), masters_f[n].numpy()
        worst = max(worst, np.abs(a - m).max())
        port_dist += np.abs(m - r).mean()
        jax_dist += np.abs(a - r).mean()
        param = dict(bf16.named_parameters())[n]
        assert torch.equal(param, masters_b[n].to(param.dtype)), n
    assert worst <= MASTER_MAX_LRS * TINY["train"]["optim"]["lr"]
    assert port_dist <= FP32_DISTANCE_RATIO * jax_dist
