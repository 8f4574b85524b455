"""Word-excitation guidance (WEG) in the PyTorch port against the JAX
package, at the tiny geometry in fp32.

The pieces of ``models/weg.py`` run on the same numpy inputs on both sides;
``Denoiser.text_only`` and the WEG loss and its gradient w.r.t. the
latents run on the same weights (JAX ``init_params`` through
``state_dict_from_jax``) and JAX's own conditions; ``sample(focus=...)``
replays JAX's noise into the port (as ``tests/test_torch_sampler.py``
does), with the JAX step kernel in interpret mode and the port's
``guided_step`` on its plain CPU version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models import weg as jax_weg
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.tokenizer import (
    focus_word_indices as jax_focus_word_indices,
)
from convofusion_tpu.ops.smoothing import (
    gaussian_kernel_2d as jax_gaussian_kernel_2d,
)
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import weg
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.tokenizer import focus_word_indices
from convofusion_tpu_torch.ops.smoothing import gaussian_kernel_2d

B, STEPS, T, LAT = 2, 10, 16, 32
TIMESTEP = 620
BATCH_KEYS = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
              "active_passive_lsn", "lsn_id")
# the map pieces are a few fp32 ops on values in [0, 1]: softmax, a 3x3
# conv, a max; observed <= 1.2e-7
MAP_TOL = 1e-6
# one text-only denoiser pass (3 layers, fp32): observed 1.6e-6 on the
# noise prediction and 3.0e-7 on the attention maps (GEMM summation
# order, exp/erf ulps), as one guided call
PASS_TOL = 1e-5
# the loss and its gradient through that pass and back: observed the same
# loss (0.9030415) and the gradient within 8.8e-11 of |grad| <= 1.3e-4
LOSS_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-9
# sample(focus=...): tests/test_torch_sampler.py's fp32 tolerance.  Each
# WEG gradient step moves the latents by ~1000 x grad (assets.yaml:18-19);
# observed <= 7.1e-5 on the latents and 1.3e-5 on the motion over 10 DDIM
# steps, where WEG itself moves the latents by 1.26-1.44
ATOL, RTOL = 2e-4, 2e-5
# refinement forced at step 0: threshold 0.99 asks for loss <= 0.01, which
# three iterations never reach from the loss of random weights
FORCED = {"thresholds": {0: 0.99}, "max_refinement_steps": 3}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_noise_sequence(key, n_steps, shape):
    """Replay diffusion_reverse's key splits (models/convofusion.py:661-665,
    751,815)."""
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, shape))
    steps = []
    for _ in range(n_steps):
        k, k_step = jax.random.split(k)
        steps.append(np.array(jax.random.normal(k_step, shape)))
    return init, np.stack(steps)


# ------------------------------------------------------------ map pieces
def test_gaussian_kernel_matches_jax():
    """The copy keeps the reference's (2 * sigma) quirk."""
    for size, sigma in ((3, 0.5), (5, 1.0)):
        np.testing.assert_array_equal(gaussian_kernel_2d(size, sigma),
                                      jax_gaussian_kernel_2d(size, sigma))


@pytest.mark.parametrize("eot", [[11, 6, 3], [5, 5, 9]])
def test_sliced_reflect_smooth_matches_jax(eot):
    p = np.random.default_rng(0).random((3, 16, 12)).astype(np.float32)
    eot = np.asarray(eot, np.int32)
    want = jax_weg.sliced_reflect_smooth(jnp.asarray(p), jnp.asarray(eot))
    got = weg.sliced_reflect_smooth(torch.from_numpy(p),
                                    torch.from_numpy(eot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MAP_TOL)


# focus columns per row (eot 10 and 7): interior, the slice's boundary
# columns (1 and eot - 1), and the eot column itself
FOCUS_CASES = {
    "interior": [[3, 5, 7], [2, 4, 5]],
    "boundary": [[1, 9, 1], [1, 6, 6]],
    "eot": [[10, 2, 10], [7, 7, 3]],
}


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", sorted(FOCUS_CASES))
def test_max_attention_at_indices_matches_jax(case, smooth):
    rng = np.random.default_rng(1)
    att = rng.standard_normal((2, 16, 12)).astype(np.float32)
    idx = np.asarray(FOCUS_CASES[case], np.int32)
    valid = np.asarray([[1, 1, 0], [1, 0, 1]], np.float32)
    eot = np.asarray([10, 7], np.int32)
    want, _ = jax_weg.max_attention_at_indices(
        jnp.asarray(att), jnp.asarray(idx), jnp.asarray(valid),
        jnp.asarray(eot), smooth)
    got, got_valid = weg.max_attention_at_indices(
        torch.from_numpy(att), torch.from_numpy(idx),
        torch.from_numpy(valid), torch.from_numpy(eot), smooth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MAP_TOL)
    np.testing.assert_array_equal(got_valid.numpy(), valid)


def test_attention_focus_loss_matches_jax():
    """A row without valid focus words contributes 0 to the batch mean."""
    rng = np.random.default_rng(2)
    max_att = rng.random((3, 4)).astype(np.float32)
    valid = np.asarray([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]],
                       np.float32)
    want = jax_weg.attention_focus_loss(jnp.asarray(max_att),
                                        jnp.asarray(valid))
    got = weg.attention_focus_loss(torch.from_numpy(max_att),
                                   torch.from_numpy(valid))
    assert abs(float(got) - float(want)) <= MAP_TOL


def test_focus_word_indices_matches_jax():
    """Repeated words give every hit; hits beyond max_indices are cut;
    a missing word or a row without focus words gives no valid index."""
    word_maps = [["<bos>", "a", "dog", "and", "a", "cat", "<eos>"],
                 ["<bos>", "maps", "<eos>", "", ""],
                 ["<bos>", "x", "<eos>"]]
    focus = [["a", "cat", "dog"], ["dragons", "maps"], []]
    for k in (2, 8):
        got = focus_word_indices(word_maps, focus, max_indices=k)
        want = jax_focus_word_indices(word_maps, focus, max_indices=k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_weg_schedule_reference_against_linspace():
    """'reference' replays the reference's reassignment of scale_range
    inside its step loop: the value at step i is lo + i (hi - lo) /
    (n - 1)^(i + 1), so it collapses to ~lo; 'linspace' decays lo -> hi.
    Both step sizes are 1000 sqrt(value), in fp32."""
    n, lo, hi = 10, 1.0, 0.5
    params = {"thresholds": {0: 0.05, 200: 0.4}}
    ref = weg.weg_schedule(params, n)
    lin = weg.weg_schedule({**params, "scale_schedule": "linspace"}, n)
    i = np.arange(n, dtype=np.float64)
    want_ref = 1000 * np.sqrt(lo + i * (hi - lo) / (n - 1) ** (i + 1))
    want_lin = 1000 * np.sqrt(np.linspace(lo, hi, n))
    np.testing.assert_allclose(ref.step_sizes, want_ref.astype(np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(lin.step_sizes, want_lin.astype(np.float32),
                               rtol=1e-6)
    assert ref.step_sizes[0] == lin.step_sizes[0] == 1000.0
    assert min(ref.step_sizes[1:]) > 996.0 > 950.0 > max(lin.step_sizes[2:])
    # only thresholds of steps that exist; the rest are -1 (none)
    assert ref.thresholds == [np.float32(0.05)] + [-1.0] * (n - 1)
    assert (ref.max_iter_to_alter, ref.max_refinement_steps) == (800, 300)
    with pytest.raises(ValueError, match="scale_schedule"):
        weg.weg_schedule({"scale_schedule": "cosine"}, n)


# ------------------------------------------------------------ model level
@pytest.fixture(scope="module")
def twins():
    cfg = tiny_config("diffusion")
    cfg.model.scheduler["variant"] = "ddim"
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    tm.scheduler = dataclasses.replace(tm.scheduler, variant="ddim")
    raw = jax_synthetic.synthetic_raw_batch(3, B)
    jbatch, _, tb_lsn = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    # focus on the first and third words of every row: the first sits on
    # column 1, the slice's boundary
    wrapped = jm.tokenizer.wrapped_texts(raw["text_lsn"])
    fi, fv = focus_word_indices(
        tb_lsn.word_map(wrapped), [[t.split()[1], t.split()[3]]
                                   for t in wrapped], max_indices=4)
    assert fv.sum(axis=1).min() >= 2
    return jm, params, tm, jbatch, tbatch, {"focus_idx": fi,
                                            "focus_valid": fv}


@pytest.fixture(scope="module")
def text_condition(twins):
    """JAX's text-only condition (branch 1) and the port's ``weg`` dict on
    the same tensors."""
    jm, params, tm, jbatch, _, focus = twins
    cond, masks = jm.encode_conditions(params, *(jbatch[k]
                                                 for k in BATCH_KEYS))
    cond_u, masks_u = jm.encode_uncond(params, jbatch)
    jtext = ({s: cond[s] if s == "tlsn" else cond_u[s] for s in cond},
             {s: masks[s] if s == "tlsn" else masks_u[s] for s in masks})
    tw = tm.weg_inputs(focus, _torch(cond), _torch(masks), _torch(cond_u),
                       _torch(masks_u))
    latents = np.random.default_rng(4).standard_normal(
        (B, T, LAT)).astype(np.float32)
    return jtext, tw, latents


def _jax_text_only(jm, params, jtext):
    def fn(lat, t):
        return jm.denoiser.apply({"params": params["denoiser"]}, lat, t,
                                 *jtext, method=jm.denoiser.text_only)
    return fn


def test_weg_inputs_match_jax(twins, text_condition):
    """eot = first pad - 1 (JAX's expression, convofusion.py:918-921);
    single-row uncond streams stay at batch 1, tlsn is the real one."""
    jm, params, tm, jbatch, _, _ = twins
    _, masks = jm.encode_conditions(params, *(jbatch[k] for k in BATCH_KEYS))
    pad = masks["tlsn"]
    want = jnp.where(jnp.any(pad, axis=1),
                     jnp.argmax(pad.astype(jnp.int32), axis=1) - 1,
                     pad.shape[1] - 1)
    _, tw, _ = text_condition
    np.testing.assert_array_equal(tw["eot_idx"].numpy(), np.asarray(want))
    assert {s: v.shape[0] for s, v in tw["cond_text"].items()} == {
        "spkemb": 1, "alsn": 1, "tlsn": B, "apb": 1, "lsnemb": 1}
    assert tw["focus_idx"].dtype == torch.int64
    assert tw["focus_valid"].dtype == torch.float32


def test_text_only_matches_jax(twins, text_condition):
    """Denoiser.text_only: noise prediction and every stream's (B, L, Tq,
    Tk) attention stack, the tlsn one being what WEG reads."""
    jm, params, tm, _, _, _ = twins
    jtext, tw, latents = text_condition
    out_j, att_j = _jax_text_only(jm, params, jtext)(jnp.asarray(latents),
                                                    jnp.asarray(TIMESTEP))
    with torch.no_grad():
        out_t, att_t = tm.denoiser.text_only(
            torch.from_numpy(latents), TIMESTEP, tw["cond_text"],
            tw["masks_text"])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=PASS_TOL)
    assert set(att_t) == set(att_j)
    for s in att_j:
        assert att_t[s].shape == att_j[s].shape, s
        np.testing.assert_allclose(att_t[s].numpy(), np.asarray(att_j[s]),
                                   rtol=0, atol=PASS_TOL, err_msg=s)
    with pytest.raises(ValueError, match="scalar"):
        tm.denoiser.text_only(torch.from_numpy(latents),
                              torch.full((B,), TIMESTEP),
                              tw["cond_text"], tw["masks_text"])


def test_weg_loss_and_grad_match_jax(twins, text_condition):
    """The WEG loss of a text-only pass and its gradient w.r.t. the
    latents against jax.value_and_grad; the port's parameters carry no
    gradient."""
    jm, params, tm, _, _, _ = twins
    jtext, tw, latents = text_condition
    jfn = _jax_text_only(jm, params, jtext)
    jloss = jax_weg.make_weg_loss(
        lambda lat, t: jfn(lat, t)[1]["tlsn"],
        jnp.asarray(tw["focus_idx"].numpy()),
        jnp.asarray(tw["focus_valid"].numpy()),
        jnp.asarray(tw["eot_idx"].numpy()))
    loss_j, grad_j = jax.value_and_grad(jloss)(jnp.asarray(latents),
                                               jnp.asarray(TIMESTEP))

    def att(lat, t):
        return tm.denoiser.text_only(lat, t, tw["cond_text"],
                                     tw["masks_text"])[1]["tlsn"]

    loss_grad = weg.value_and_grad(weg.make_weg_loss(
        att, tw["focus_idx"], tw["focus_valid"], tw["eot_idx"]))
    with torch.no_grad():
        loss_t, grad_t = loss_grad(torch.from_numpy(latents), TIMESTEP)
    assert 0.0 < float(loss_j) < 1.0
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_TOL
    assert np.abs(np.asarray(grad_j)).max() > 0
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not loss_t.requires_grad and not grad_t.requires_grad
    assert not any(p.requires_grad for p in tm.parameters())


@pytest.mark.parametrize("weg_params,refined", [
    (None, 0), (FORCED, 3), ({"scale_schedule": "linspace"}, 0)],
    ids=["default", "forced_refinement", "linspace"])
def test_sample_with_focus_matches_jax(twins, weg_params, refined):
    """sample(focus=...) with JAX's noise replayed: the config's
    parameters (no refinement: the step-0 threshold 0.05 asks for loss >
    0.95); refinement forced at step 0; and the 'linspace' schedule.
    Every step takes one loss + gradient pass; a refined step adds the
    refinement's first pass, its iterations and a fresh pass."""
    jm, params, tm, jbatch, tbatch, focus = twins
    key = jax.random.PRNGKey(1)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k, f: jm.sample(p, b, k, num_inference_steps=STEPS,
                                     focus=f, weg_params=weg_params))(
        params, jbatch, key, focus)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, LAT))
    tm.weg_counts = type(tm.weg_counts)()
    motion_t, lat_t = tm.sample(tbatch, num_inference_steps=STEPS,
                                init_noise=torch.from_numpy(init),
                                step_noise=torch.from_numpy(steps),
                                focus=focus, weg_params=weg_params)
    counts = tm.weg_counts
    assert counts.refinement_iterations == refined
    assert counts.refined_steps == (1 if refined else 0)
    assert counts.text_only_passes == STEPS + (refined + 2 if refined else 0)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j),
                               rtol=RTOL, atol=ATOL)


def test_focus_without_valid_words_is_a_no_op(twins):
    """An all-invalid focus mask (a service request without focus words)
    gives loss 0 and a zero gradient: the latents, and so the motion, are
    bit-equal to focus=None."""
    _, _, tm, _, tbatch, focus = twins
    none = {"focus_idx": focus["focus_idx"],
            "focus_valid": np.zeros_like(focus["focus_valid"])}
    runs = [tm.sample(tbatch, torch.Generator().manual_seed(3),
                      num_inference_steps=3, focus=f)
            for f in (None, none)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])
