"""The long-form rollout of the PyTorch port against the JAX package.

Both sides run the tiny diffusion geometry on the same weights (JAX
``init_params`` through ``state_dict_from_jax``) and the same long batch
(``synthetic_long_batch``, a copy on each side).  JAX's noise is replayed
into the port: each window's (init, step) draws follow the rollout's
``key, k = split(key)`` and ``diffusion_reverse``'s own splits.  The JAX
step kernel runs in interpret mode, the port's ``guided_step`` on its
plain CPU version.  Also held to JAX here: the preseq reverse process, the
window text, focus-word selection and the result dump.
"""
import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from convofusion_tpu.cli import focus as jax_focus
from convofusion_tpu.cli import unbounded as jax_unbounded
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import audio as jax_audio
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models import results as jax_results
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.convofusion import (
    gen_from_latent as jax_gen_from_latent,
)
from convofusion_tpu_torch.cli import focus, unbounded
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import audio
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models import convofusion as port
from convofusion_tpu_torch.models import results
from convofusion_tpu_torch.models.convofusion import (
    Convofusion,
    gen_from_latent,
)

B, T, LAT = 2, 16, 32
PRE = 8             # preseq tokens: half the window's latents
STEPS = 10          # diffusion_reverse(preseq=...)
ROLL_STEPS = 4      # rollout windows
BATCH_KEYS = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
              "active_passive_lsn", "lsn_id")
# tests/test_torch_sampler.py's fp32 tolerance: the guidance combine scales
# one denoiser call's rounding (~2e-6) by gs * 5 = 37.5 and the steps
# compound it; without clipping the latents grow, hence the relative term.
# Observed: preseq DDIM-10 / DDPM-10 latents 2.7e-5 / 6.0e-5, DDPM-10
# unclipped 3.0e-4 at |x| ~ 90; rollout motion 1.9e-5 a window (no growth
# over 3 windows), 2.5e-5 with WEG
ATOL, RTOL = 2e-4, 2e-5
# one model call through 3 layers, as tests/test_torch_denoiser.py holds
# a denoiser call; observed 2.9e-6 there
CALL_TOL = 2e-5


def _t(tree):
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


def _rollout_noise(key, n_windows, n_steps, shape):
    """Each window's noise: the rollout splits ``key, k`` once a window
    (cli/unbounded.py:168) and samples with k."""
    out = []
    for _ in range(n_windows):
        key, k = jax.random.split(key)
        out.append(tuple(torch.from_numpy(a) for a in
                         _jax_noise_sequence(k, n_steps, shape)))
    return out


@pytest.fixture(scope="module")
def weights():
    jm = JaxConvofusion(tiny_config("diffusion"))
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(0)))


def _twins(weights, variant, clip=True):
    cfg = tiny_config("diffusion")
    cfg.model.scheduler["variant"] = variant
    cfg.model.scheduler.params["clip_sample"] = clip
    jm = JaxConvofusion(cfg)
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(weights))
    tm.scheduler = dataclasses.replace(tm.scheduler, variant=variant,
                                       clip_sample=clip)
    return jm, tm


# --------------------------------------------------- preseq reverse process
@pytest.mark.parametrize("variant,clip", [("ddpm", True), ("ddim", True),
                                          ("ddpm", False)])
def test_preseq_reverse_matches_jax(weights, variant, clip, monkeypatch):
    """diffusion_reverse(preseq=...) on JAX's conditions and noise, with
    the reference's aliasing quirk (step 0 re-noises the preseq with the
    initial noise, later steps with the step-0 noised preseq).  With
    clipping both sides take the fused step (the port's ``guided_step``
    once a step); without, the plain combine and scheduler step."""
    jm, tm = _twins(weights, variant, clip)
    assert tm.uses_step_kernel() == clip
    raw = jax_synthetic.synthetic_raw_batch(5, B)
    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    cond, masks = jm.encode_conditions(weights, *(jbatch[k]
                                                  for k in BATCH_KEYS))
    cond_u, masks_u = jm.encode_uncond(weights, jbatch)
    preseq = np.random.default_rng(6).standard_normal(
        (B, PRE, LAT)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(7)
    lat_j, _ = jax.jit(lambda p, c, m, cu, mu, k, ps: jm.diffusion_reverse(
        p, c, m, cu, mu, k, B, STEPS, preseq=ps))(
        weights, cond, masks, cond_u, masks_u, key, jnp.asarray(preseq))
    init, steps = _jax_noise_sequence(key, STEPS, (B, T, LAT))

    calls, step = [], port.guided_step
    monkeypatch.setattr(port, "guided_step",
                        lambda *a: calls.append(1) or step(*a))
    with torch.no_grad():
        lat_t = tm.diffusion_reverse(
            _t(cond), _t(masks), _t(cond_u), _t(masks_u), B, STEPS,
            init_noise=torch.from_numpy(init),
            step_noise=torch.from_numpy(steps),
            preseq=torch.from_numpy(preseq))
    assert len(calls) == (STEPS if clip else 0)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                               rtol=RTOL, atol=ATOL)


def test_preseq_inpainting_keeps_overlap_tokens(weights):
    """The port's mirror of tests/test_unbounded.py's check: at the last
    step add_noise is ~the identity (alphas_cumprod[0] ~= 0.99915), so the
    overwritten tokens end near the preseq and the free ones do not."""
    jm, tm = _twins(weights, "ddpm")
    raw = jax_synthetic.synthetic_raw_batch(0, B)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    preseq = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, PRE, LAT)).astype(np.float32)) * 0.5
    _, latents = tm.sample(tbatch, torch.Generator().manual_seed(2), 4,
                           preseq=preseq)
    assert (latents[:, :PRE] - preseq).abs().mean() < 0.2
    assert (latents[:, PRE:] - preseq).abs().mean() > 0.2


# ----------------------------------------------------------------- rollout
def _long_batch(seed, n_parts=2):
    batch = jax_synthetic.synthetic_long_batch(seed, B, n_parts=n_parts)
    batch["spk_name"] = ["anne", "carl"]
    batch["lsn_name"] = ["ben", "dora"]
    return batch


def test_synthetic_long_batch_is_a_copy():
    want = jax_synthetic.synthetic_long_batch(3, 4, n_parts=2)
    got = torch_synthetic.synthetic_long_batch(3, 4, n_parts=2)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = \
                os.path.join(d, f)
    return out


def _check_root_continuity(outs):
    """Window k's frame 0 root xz is window k-1's frame 64 root xz."""
    for k in range(1, len(outs)):
        np.testing.assert_allclose(outs[k][:, 0, [0, 2]],
                                   outs[k - 1][:, 64, [0, 2]], atol=1e-4)


def test_rollout_matches_jax(weights, tmp_path):
    """2 parts (3 windows), DDPM-4 through the step kernel's gate: every
    window's stitched motion, the root continuity, and the dump tree
    (the same files; texts, wavs and meta equal; .npy within ATOL)."""
    jm, tm = _twins(weights, "ddpm")
    batch = _long_batch(11)
    key = jax.random.PRNGKey(12)
    outs_j = jax_unbounded.rollout(jm, weights, batch, key,
                                   num_inference_steps=ROLL_STEPS,
                                   save_dir=str(tmp_path / "jax"),
                                   verbose=False)
    noise = _rollout_noise(key, 3, ROLL_STEPS, (B, T, LAT))
    outs_t = unbounded.rollout(tm, batch, num_inference_steps=ROLL_STEPS,
                               save_dir=str(tmp_path / "port"),
                               verbose=False, noise=noise)
    assert len(outs_t) == len(outs_j) == 3
    for o_t, o_j in zip(outs_t, outs_j):
        assert o_t.shape == (B, 128, 189) and o_t.dtype == np.float32
        np.testing.assert_allclose(o_t, o_j, rtol=RTOL, atol=ATOL)
    _check_root_continuity(outs_t)

    tree_j, tree_t = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tree_t) == sorted(tree_j)
    assert len(tree_t) == 3 * B * 9
    for rel, pj in tree_j.items():
        pt = tree_t[rel]
        if rel.endswith(".npy"):
            a, b = np.load(pj), np.load(pt)
            if rel.endswith("pred.npy"):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                           err_msg=rel)
            else:
                np.testing.assert_array_equal(b, a, err_msg=rel)
        else:
            with open(pj, "rb") as f1, open(pt, "rb") as f2:
                assert f1.read() == f2.read(), rel


def test_rollout_with_weg_matches_jax(weights):
    """weg_type='random' with one seed on both sides (random.seed for
    JAX's module-global draws, random.Random for the port's), DDIM-4: the
    rollout's WEG constants, focus words from each window's
    non-overlapping half; motion within tests/test_torch_weg.py's 2e-4.
    The model's own weg_parameters stay as they were."""
    jm, tm = _twins(weights, "ddim")
    before = dict(tm.weg_parameters)
    batch = _long_batch(13)
    key = jax.random.PRNGKey(14)
    random.seed(15)
    outs_j = jax_unbounded.rollout(jm, weights, batch, key,
                                   num_inference_steps=ROLL_STEPS,
                                   weg_type="random", verbose=False)
    tm.weg_counts = type(tm.weg_counts)()
    outs_t = unbounded.rollout(
        tm, batch, num_inference_steps=ROLL_STEPS, weg_type="random",
        verbose=False, rng=random.Random(15),
        noise=_rollout_noise(key, 3, ROLL_STEPS, (B, T, LAT)))
    # a text-only pass every step of a window with valid focus words
    assert tm.weg_counts.text_only_passes % ROLL_STEPS == 0
    assert tm.weg_counts.text_only_passes > 0
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o_t, o_j, rtol=RTOL, atol=ATOL)
    _check_root_continuity(outs_t)
    assert tm.weg_parameters == before


def test_rollout_weg_parameters_are_the_reference_constants(weights,
                                                            monkeypatch):
    """The rollout samples with ROLLOUT_WEG_PARAMETERS (JAX's dict, the
    reference's hardcoded forecast constants), threaded through the cached
    sampler; without WEG with none; the uncond branch is encoded once a
    sampler, by the first window."""
    assert unbounded.ROLLOUT_WEG_PARAMETERS == \
        jax_unbounded.ROLLOUT_WEG_PARAMETERS
    assert unbounded.UNCOND == jax_unbounded.UNCOND
    _, tm = _twins(weights, "ddim")
    before = dict(tm.weg_parameters)
    assert before.get("scale_factor") != 100
    seen, encodes = [], []

    def fake_sample(arrays, generator=None, n=None, init_noise=None,
                    step_noise=None, uncond_cache=None, focus=None,
                    weg_params=None, preseq=None, capture_attention="none"):
        assert capture_attention == "none"
        seen.append((weg_params, preseq is None))
        b = arrays["lsn_id"].shape[0]
        return torch.zeros(b, 128, 189), torch.zeros(b, T, LAT)

    encode = tm.encode_uncond
    monkeypatch.setattr(tm, "sample", fake_sample)
    monkeypatch.setattr(tm, "encode_uncond",
                        lambda b: encodes.append(1) or encode(b))
    batch = _long_batch(16, n_parts=3)
    for weg_type in ("random", "no"):
        unbounded.rollout(tm, batch, num_inference_steps=2,
                          weg_type=weg_type, verbose=False,
                          rng=random.Random(0))
    want = unbounded.ROLLOUT_WEG_PARAMETERS
    assert seen == [(want, True)] + [(want, False)] * 4 + \
        [(None, True)] + [(None, False)] * 4
    assert len(encodes) == 2
    assert tm.weg_parameters == before


def test_rollout_on_a_generator_is_seeded(weights):
    """Without injected noise the windows draw from the generator: one
    seed, one result."""
    _, tm = _twins(weights, "ddim")
    batch = _long_batch(17)
    runs = [unbounded.rollout(tm, batch, torch.Generator().manual_seed(3),
                              num_inference_steps=2, verbose=False)
            for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        unbounded.rollout(tm, batch, num_inference_steps=2, verbose=False)


# ------------------------------------------------------------- window text
_segment = st.tuples(st.floats(0.0, 14.0), st.floats(0.05, 1.5),
                     st.sampled_from(["hi", "maps", "dragons", "dice"]))


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(st.lists(_segment, max_size=10), min_size=1,
                     max_size=3),
       window=st.integers(0, 4))
def test_process_text_matches_jax(rows, window):
    """Word segments (sorted by start, as whisper gives them) against the
    JAX window text for one of a 3-part clip's windows."""
    seg_batch = [[[[s, s + d], w] for s, d, w in sorted(row)]
                 for row in rows]
    time_len = 128 / 25
    t0, t1 = window / 2 * time_len, (window / 2 + 1) * time_len
    assert unbounded.process_text(seg_batch, t0, t1) == \
        jax_unbounded.process_text(seg_batch, t0, t1)


def test_process_text_uncond_and_empty_rows():
    rows = [unbounded.UNCOND, None, [[[0.0, 1.0], "hello"]]]
    assert unbounded.process_text(rows, 0.0, 5.12) == \
        jax_unbounded.process_text(rows, 0.0, 5.12) == \
        [unbounded.UNCOND, "", "hello"]


# ------------------------------------------------------------ focus words
TEXTS = ["the brave knights fight mighty dragons tonight",
         "we roll dice", "a an the", "", "maps and dragons around this table"]


def test_select_focus_words_matches_jax():
    """'no', 'semantic' (non-string words dropped), seeded 'random' over
    several seeds, and an unknown type."""
    assert focus.select_focus_words("no", TEXTS) == \
        jax_focus.select_focus_words("no", TEXTS) == []
    sem = [[{"word": "dragons", "name": "semantic"},
            {"word": float("nan"), "name": "beat"}], [], None]
    assert focus.select_focus_words("semantic", TEXTS[:3], sem) == \
        jax_focus.select_focus_words("semantic", TEXTS[:3], sem) == \
        [["dragons"], [], []]
    for seed in range(20):
        random.seed(seed)
        want = jax_focus.select_focus_words("random", TEXTS)
        assert focus.select_focus_words(
            "random", TEXTS, rng=random.Random(seed)) == want, seed
    for mod in (focus, jax_focus):
        with pytest.raises(ValueError):
            mod.select_focus_words("bogus", TEXTS)
    with pytest.raises(ValueError, match="random.Random"):
        focus.select_focus_words("random", TEXTS)


# ------------------------------------------------------------ result dump
def test_save_generation_results_matches_jax(tmp_path):
    """Every optional part of the dump: attention maps, word maps, focus
    words, sem_lsn and sem_info (the csv module against pandas)."""
    rng = np.random.default_rng(18)
    n = 2
    kw = dict(
        gt=rng.standard_normal((n, 128, 189)).astype(np.float32),
        pred=rng.standard_normal((n, 128, 189)).astype(np.float32),
        lengths=[128, 100], names=["a/x", "b/y"],
        texts_lsn=["hello there", "maps"], texts_spk=["hi", "dice"],
        audios_lsn=rng.standard_normal((n, 800)).astype(np.float32),
        audios_spk=rng.standard_normal((n, 800)).astype(np.float32) * 0.5,
        motion_spk=rng.standard_normal((n, 128, 189)).astype(np.float32),
        spk_names=["s1", "s2"], apb=np.asarray([[0, 1], [1, 1]]),
        att_maps={"tlsn": rng.random((3, n, 2, 16, 7)).astype(np.float32)},
        att_timesteps=[900, 500, 100],
        word_maps={"lsn": [["<bos>", "hello"], ["maps"]],
                   "spk": [["hi"], ["dice", "<eos>"]]},
        focus_words=[["hello", "there"], [("maps", "x")]],
        sem_lsn=rng.random((n, 128)).astype(np.float32),
        sem_info=[[{"name": "semantic", "start": 0.0,
                    "end": np.float64(1.25), "word": "hello"},
                   {"name": "beat", "start": 0.5, "end": 2.0,
                    "word": float("nan")}], []])
    jax_results.save_generation_results(str(tmp_path / "jax"), **kw)
    results.save_generation_results(str(tmp_path / "port"), **kw)
    tree_j, tree_t = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tree_t) == sorted(tree_j)
    assert any(rel.endswith("sem_info_lsn.csv") for rel in tree_t)
    for rel, pj in tree_j.items():
        with open(pj, "rb") as f1, open(tree_t[rel], "rb") as f2:
            assert f1.read() == f2.read(), rel


SEM_ROWS = {
    "beat": [{"name": "semantic", "start": 0.0, "end": np.float64(1.25),
              "word": "dragons"},
             {"name": "beat", "start": np.float64(0.3), "end": 2.0,
              "word": float("nan")}],
    "mixed": [{"a": 1, "b": True, "c": "x\ty"},
              {"a": 2, "b": False, "c": 'q"u'}],
    "missing": [{"a": 1, "b": 2.5}, {"a": None, "c": "z"}],
    "floats": [{"a": 1e-5, "b": 1e16, "c": 3}, {"a": 0.1, "b": -2.0,
                                                "c": 4}],
    "empty_strings": [{"a": ""}, {"a": "x"}],
}


@pytest.mark.parametrize("case", sorted(SEM_ROWS))
def test_write_sem_info_matches_pandas(case, tmp_path):
    rows = SEM_ROWS[case]
    pd.DataFrame(rows).to_csv(tmp_path / "pd.csv", index=False, sep="\t")
    results.write_sem_info(tmp_path / "port.csv", rows)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pd.csv").read_bytes()


def test_save_vae_results_and_unnormalize_match_jax(tmp_path):
    rng = np.random.default_rng(19)
    gt, pred = (rng.standard_normal((2, 128, 189)).astype(np.float32)
                for _ in range(2))
    np.testing.assert_array_equal(results.unnormalize_motion(gt[0]),
                                  jax_results.unnormalize_motion(gt[0]))
    assert results.ATT_NAMES == jax_results.ATT_NAMES
    jax_results.save_vae_results(str(tmp_path / "jax"), gt, pred, [128, 64],
                                 ["p", "q"])
    results.save_vae_results(str(tmp_path / "port"), gt, pred, [128, 64],
                             ["p", "q"])
    tree_j, tree_t = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tree_t) == sorted(tree_j) and len(tree_t) == 4
    for rel, pj in tree_j.items():
        np.testing.assert_array_equal(np.load(tree_t[rel]), np.load(pj))


def test_save_wav_matches_jax(tmp_path):
    y = np.random.default_rng(20).standard_normal(1000).astype(np.float32)
    jax_audio.save_wav(str(tmp_path / "j.wav"), y, 16000)
    audio.save_wav(str(tmp_path / "t.wav"), y, 16000)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()


def test_gen_from_latent_matches_jax(weights):
    jm, tm = _twins(weights, "ddim")
    z = np.random.default_rng(21).standard_normal(
        (2, B, 8, LAT)).astype(np.float32)
    want = np.asarray(jax_gen_from_latent(jm, weights, jnp.asarray(z)))
    with torch.no_grad():
        got = gen_from_latent(tm, torch.from_numpy(z))
    assert got.shape == (B, 128, 189)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CALL_TOL)
