"""The port's offline evaluation (``eval/``) against the JAX package's.

- ``HalfEmbeddingNet`` on the random init of ``init_params(0)`` (the same
  numpy draws on both sides) and through ``load_torch_fidnet`` of a state
  dict saved in the reference's names (a DDP ``module.`` prefix, under
  ``model_state``, with a decoder entry the encoder ignores): features
  within 1e-5 of the largest (fp32 convolutions and GEMMs of up to 17,700
  terms, summed in another order).
- ``evaluate_results`` of both packages over one dump of 4 clips with
  onset-bearing audio, monadic and dyadic (random-init FID): the same keys,
  each value within 1e-5 relative.
- The onset chain, the metrics and the FID sentinel on the same inputs:
  exact or within 1e-6.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.data.audio import save_wav
from convofusion_tpu.eval import fid_net as jax_fid
from convofusion_tpu.eval import metrics as jax_metrics
from convofusion_tpu.eval import onsets as jax_onsets
from convofusion_tpu.eval import run as jax_run
from convofusion_tpu_torch.eval import fid_net, metrics, onsets
from convofusion_tpu_torch.eval import run as port_run

FEATURE_TOL = 1e-5
KEY_RTOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    jnet = jax_fid.HalfEmbeddingNet(128, 189, 300)
    jparams = jnet.init_params(0)
    net = fid_net.HalfEmbeddingNet(128, 189, 300)
    net.load_state_dict(net.init_params(0))
    return jnet, jparams, net


def _poses(seed, n=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 128, 189)).astype(np.float32)


def test_random_init_features_match_jax(nets):
    jnet, jparams, net = nets
    x = _poses(0)
    want = np.asarray(jnet(jparams, jnp.asarray(x)))
    got = port_run.fid_features(net, x)
    assert got.shape == want.shape == (3, 300)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_TOL * np.abs(want).max())
    assert not net.training
    net.train()                      # BatchNorm keeps its statistics
    assert not net.training


def test_load_torch_fidnet_round_trip_matches_jax(tmp_path):
    """A small-width net (feature length 32) with random BatchNorm
    statistics, saved in the reference's names: the port loads it with
    load_state_dict, JAX through its converter; the same features."""
    torch.manual_seed(0)
    src = fid_net.HalfEmbeddingNet(128, 189, 32)
    sd = {}
    for k, v in src.state_dict().items():
        v = v.clone()
        if k.endswith("running_mean"):
            v.uniform_(-0.5, 0.5)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5)
        elif v.is_floating_point():
            v.normal_(0.0, 0.05)
        sd["module." + k] = v
    sd["module.decoder.weight"] = torch.zeros(3)
    path = str(tmp_path / "last_499.bin")
    torch.save({"model_state": sd}, path)

    loaded = fid_net.load_torch_fidnet(path)
    assert set(loaded) == set(src.state_dict())
    net = fid_net.HalfEmbeddingNet(128, 189, 32)
    net.load_state_dict(loaded)
    x = _poses(1)
    want = np.asarray(jax_fid.HalfEmbeddingNet(128, 189, 32)(
        jax_fid.load_torch_fidnet(path), jnp.asarray(x)))
    got = port_run.fid_features(net, x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """4 clips under nested names: smooth random motion (the y axis off
    the floor), predictions near it, 1.5 Hz audio bursts, semantic
    scores on 3 of them."""
    root = tmp_path_factory.mktemp("eval_dump")
    rng = np.random.default_rng(2)
    t = np.arange(int(5.12 * 16000)) / 16000
    for i in range(4):
        d = root / "exp" / f"set_{i // 2}" / f"sample_{i}"
        d.mkdir(parents=True)
        walk = np.cumsum(rng.normal(scale=0.01, size=(128, 63, 3)), axis=0)
        gt = (walk + rng.normal(scale=0.1, size=(1, 63, 3))).astype(
            np.float32)
        gt[:, :, 1] += 1.0
        pred = gt + rng.normal(scale=0.02, size=gt.shape).astype(np.float32)
        np.save(d / "gt.npy", gt)
        np.save(d / "pred.npy", pred)
        if i:
            np.save(d / "sem_lsn.npy", rng.uniform(0, 0.3, 128).astype(
                np.float32))
        env = (np.sin(2 * np.pi * (1.0 + 0.3 * i) * t) > 0.5).astype(
            np.float32)
        save_wav(str(d / "lsn_audio.wav"),
                 env * np.sin(2 * np.pi * 220 * t), 16000)
    return str(root)


@pytest.mark.parametrize("mode", ["monadic", "dyadic"])
def test_evaluate_results_matches_jax(dump, mode, nets):
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        want = jax_run.evaluate_results(
            dump, mode, fidnet_path=os.path.join(dump, "none.bin"))
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = port_run.main(["--result_dir", dump, "--mode", mode,
                             "--fidnet", os.path.join(dump, "none.bin"),
                             "--device", "cpu"])
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= KEY_RTOL * abs(v), (k, got[k], v)
    assert got["n_samples"] == 4 and got["alignment"] is not None
    if mode == "dyadic":
        assert np.isfinite(got["fid_random_init_features"])
        assert "fid" not in got
    else:
        # one clip has no semantic scores: flagged, as JAX flags it
        assert "srgr_missing_sem" in got
    # evaluate_results' own warnings (SciPy's deprecation of JAX's
    # sqrtm(disp=) aside)
    msgs = sorted(str(x.message)[:40] for x in w_port
                  if x.category is UserWarning)
    assert msgs == sorted(str(x.message)[:40] for x in w_jax
                          if x.category is UserWarning)


def test_evaluate_results_needs_a_card_or_a_device(dump, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_run.evaluate_results(dump, "monadic")


def test_onsets_and_metrics_match_jax():
    sr = 16000
    t = np.arange(int(5.12 * sr)) / sr
    env = (np.sin(2 * np.pi * 2.0 * t) > 0.6).astype(np.float32)
    y = env * np.sin(2 * np.pi * 330 * t).astype(np.float32)
    for a, b in zip(onsets.audio_beats(y, sr), jax_onsets.audio_beats(y, sr)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(onsets.onset_strength(y, sr),
                               jax_onsets.onset_strength(y, sr), rtol=1e-6,
                               atol=1e-6)
    assert onsets.audio_beats(np.zeros(sr, np.float32), sr)[0] is None

    rng = np.random.default_rng(3)
    pose = np.cumsum(rng.normal(size=(128, 189)), axis=0).astype(np.float32)
    got = metrics.Alignment(0.3, 10).pose_beats(pose)
    want = jax_metrics.Alignment(0.3, 10).pose_beats(pose)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
    m = rng.normal(size=(128, 63, 3)).astype(np.float32)
    np.testing.assert_array_equal(metrics.eval_process_motion(m),
                                  jax_metrics.eval_process_motion(m))
    feats = [rng.normal(size=(20, 3)) for _ in range(5)]
    assert metrics.calculate_avg_distance(feats) == \
        jax_metrics.calculate_avg_distance(feats)
    f = rng.normal(size=(6, 4))
    assert metrics.calc_diversity(f) == jax_metrics.calc_diversity(f)
    assert metrics.calculate_jitter(m[1:], m[:-1]) == \
        jax_metrics.calculate_jitter(m[1:], m[:-1])
    a, b = rng.normal(size=(60, 8)), rng.normal(size=(60, 8)) + 1.0
    assert metrics.frechet_distance(a, b) == jax_metrics.frechet_distance(
        a, b)


def test_frechet_distance_ill_conditioned_sentinel(monkeypatch):
    fake = np.eye(8) + 1j * 0.5 * np.eye(8)
    monkeypatch.setattr(metrics.linalg, "sqrtm", lambda m: fake)
    rng = np.random.default_rng(0)
    assert metrics.frechet_distance(rng.standard_normal((50, 8)),
                                    rng.standard_normal((50, 8))) == 1e10
