"""The port's audio, text and motion preprocessing against the JAX package.

Host numpy paths are held to JAX exactly (the same numpy operations in
the same order): the mel filterbank, the STFT, ``melspectrogram`` through
the native C++ kernel and through numpy, ``mel_db``, TextGrid parsing,
``process_motion``, ``resample_motion_fps``, ``check_audio`` and wav IO.
The torch batch mel is held to ``melspectrogram_batch_jax`` within 1e-4
of the largest power (fp32 FFTs in another order), and the torch
quaternion and geometry functions to their ``jnp`` twins within 1e-5.
"""
import numpy as np
import pytest
import torch

from convofusion_tpu import native as jax_native
from convofusion_tpu.data import audio as jax_audio
from convofusion_tpu.data import dataset as jax_dataset
from convofusion_tpu.data import text as jax_text
from convofusion_tpu.utils import geometry as jax_geo
from convofusion_tpu.utils import quaternion as jax_quat
from convofusion_tpu_torch import native
from convofusion_tpu_torch.data import audio, dataset, text
from convofusion_tpu_torch.utils import geometry, profiling, quaternion

SR = 16000
# the torch batch mel: fp32 FFT and matmul against JAX's, relative to the
# largest power; and its dB against the numpy dB
BATCH_MEL_RTOL, BATCH_DB_ATOL = 1e-4, 1e-2
# quaternion and geometry functions in fp32 against jnp
GEO_ATOL = 1e-5


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    t = np.arange(int(5.12 * SR)) / SR
    speech = (0.3 * np.sin(2 * np.pi * 220 * t)
              * (np.sin(2 * np.pi * 2.3 * t) > 0)
              + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
    odd = rng.normal(size=SR + 123).astype(np.float32) * 0.2
    return [speech, odd]


def test_filterbank_window_and_stft_match_jax(signals):
    for sr, n_fft, n_mels in ((16000, 2048, 80), (22050, 1024, 64)):
        np.testing.assert_array_equal(
            audio.mel_filterbank(sr, n_fft, n_mels),
            jax_audio.mel_filterbank(sr, n_fft, n_mels))
    np.testing.assert_array_equal(audio.hann_window(2048),
                                  jax_audio.hann_window(2048))
    np.testing.assert_array_equal(audio.hz_to_mel([0, 500, 4000.0]),
                                  jax_audio.hz_to_mel([0, 500, 4000.0]))
    np.testing.assert_array_equal(audio.mel_to_hz([0, 10, 40.0], htk=True),
                                  jax_audio.mel_to_hz([0, 10, 40.0],
                                                      htk=True))
    for y in signals:
        np.testing.assert_array_equal(audio.stft_power(y),
                                      jax_audio.stft_power(y))


def test_melspectrogram_native_and_numpy_paths_match_jax(signals,
                                                         monkeypatch):
    """The native kernel where it builds (it does here: g++ is baked in)
    and the numpy fallback, each equal to JAX's same path; the path taken
    is counted."""
    assert native.available(), native.status()
    assert jax_native.available()
    before = dict(profiling.COUNTS)
    for y in signals:
        np.testing.assert_array_equal(audio.melspectrogram(y),
                                      jax_audio.melspectrogram(y))
        np.testing.assert_array_equal(audio.mel_db(y), jax_audio.mel_db(y))
    assert profiling.COUNTS["melspec.native"] - \
        before.get("melspec.native", 0) == 4
    monkeypatch.setattr(native, "melspec_power", lambda *a: None)
    monkeypatch.setattr(jax_native, "melspec_power", lambda *a: None)
    for y in signals:
        np.testing.assert_array_equal(audio.melspectrogram(y),
                                      jax_audio.melspectrogram(y))
    assert profiling.COUNTS["melspec.numpy"] - \
        before.get("melspec.numpy", 0) == 2


def test_batch_mel_matches_jax(signals):
    """melspectrogram_batch / power_to_db_batch against the JAX batch
    functions, and against the host path."""
    y = np.stack([signals[0], signals[0][::-1].copy()])
    got = audio.melspectrogram_batch(torch.from_numpy(y)).numpy()
    want = np.asarray(jax_audio.melspectrogram_batch_jax(y))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BATCH_MEL_RTOL * want.max()
    host = audio.melspectrogram(y[0])
    assert np.abs(got[0] - host).max() <= BATCH_MEL_RTOL * host.max()
    db = audio.power_to_db_batch(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(
        db, np.asarray(jax_audio.power_to_db_jax(want)), atol=BATCH_DB_ATOL)
    assert np.abs(db[0] - audio.power_to_db(host)).max() <= BATCH_DB_ATOL


def test_db_normalize_and_wav_io_match_jax(signals, tmp_path):
    y = signals[0]
    for fn in ("power_to_db", "amplitude_to_db", "normalize"):
        np.testing.assert_array_equal(getattr(audio, fn)(np.abs(y) + 1e-3),
                                      getattr(jax_audio, fn)(np.abs(y)
                                                             + 1e-3))
    path = str(tmp_path / "a.wav")
    audio.save_wav(path, y, SR)
    for sr in (SR, 8000):
        a, sa = audio.load_wav(path, sr)
        b, sb = jax_audio.load_wav(path, sr)
        assert sa == sb == sr
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(audio.resample_linear(y, SR, 22050),
                                  jax_audio.resample_linear(y, SR, 22050))


def test_textgrid_long_and_short_match_jax(tmp_path):
    long_path = str(tmp_path / "w.TextGrid")
    words = ["hello", "there", "", "brave knights"]
    bounds = [0.0, 0.4, 1.1, 1.5, 2.25]
    text.write_textgrid(long_path, words, bounds[:-1], bounds[1:], 2.25)
    with open(long_path) as f:
        written = f.read()
    jax_path = str(tmp_path / "j.TextGrid")
    jax_text.write_textgrid(jax_path, words, bounds[:-1], bounds[1:], 2.25)
    with open(jax_path) as f:
        assert f.read() == written
    short_path = str(tmp_path / "s.TextGrid")
    with open(short_path, "w") as f:
        f.write('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
                '0\n2.25\n<exists>\n1\n"IntervalTier"\n"words"\n0\n2.25\n'
                '3\n0\n0.4\n"hello"\n0.4\n1.1\n"there"\n1.1\n2.25\n""\n')
    for path in (long_path, short_path):
        got, want = text.parse_textgrid(path), jax_text.parse_textgrid(path)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert list(text.parse_textgrid(long_path)["text"]) == words


def test_motion_canonicalization_matches_jax():
    rng = np.random.default_rng(1)
    raw = [rng.uniform(-400, 400, size=(128, 67, 3)).astype(np.float32)
           + np.array([0, 1200, 0], np.float32) for _ in range(3)]
    got = dataset.process_motion(raw, (18, 13, 9, 5))
    want = jax_dataset.process_motion(raw, (18, 13, 9, 5))
    for a, b in zip(got, want):
        assert a.shape == (128, 189) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    clip = rng.normal(size=(613, 67, 3)).astype(np.float32)
    np.testing.assert_array_equal(dataset.resample_motion_fps(clip),
                                  jax_dataset.resample_motion_fps(clip))
    t = np.arange(int(5.12 * SR)) / SR
    voiced = (0.2 * np.sin(2 * np.pi * 200 * t)
              * (t % 1.0 < 0.4)).astype(np.float32)
    for y in (voiced, np.zeros_like(voiced), voiced[: SR]):
        np.testing.assert_array_equal(dataset.check_audio(y),
                                      jax_dataset.check_audio(y))
    np.testing.assert_array_equal(dataset.uncond_mel_np((161, 80)),
                                  jax_dataset.uncond_mel_np((161, 80)))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=GEO_ATOL, rtol=0)


def test_quaternion_matches_jnp():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 7, 4)).astype(np.float32)
    r = rng.normal(size=(5, 7, 4)).astype(np.float32)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    w = rng.normal(size=(5, 7, 3)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    tq, tr, tv, tw = (torch.from_numpy(a) for a in (qn, r, v, w))
    _close(quaternion.qnormalize(torch.from_numpy(q)),
           jax_quat.qnormalize(q))
    _close(quaternion.qinv(tq), jax_quat.qinv(qn))
    _close(quaternion.qmul(tq, tr), jax_quat.qmul(qn, r))
    _close(quaternion.qrot(tq, tv), jax_quat.qrot(qn, v))
    _close(quaternion.qbetween(tv, tw), jax_quat.qbetween(v, w))
    # one rotation broadcast over every joint, as process_motion uses it
    _close(quaternion.qrot(tq[:1, :1], tv), jax_quat.qrot(qn[:1, :1], v))
    np.testing.assert_array_equal(quaternion.qrot_np(qn, v),
                                  jax_quat.qrot_np(qn, v))
    np.testing.assert_array_equal(quaternion.qbetween_np(v, w),
                                  jax_quat.qbetween_np(v, w))
    np.testing.assert_array_equal(quaternion.qfix_np(q),
                                  jax_quat.qfix_np(q))


def test_geometry_matches_jnp():
    rng = np.random.default_rng(3)
    j = 6
    euler_deg = rng.uniform(-170, 170, size=(4, j * 3)).astype(np.float32)
    e_rad = np.deg2rad(euler_deg.reshape(4, j, 3)).astype(np.float32)
    te = torch.from_numpy(e_rad)
    mats = jax_geo.euler_to_matrix_xyz(e_rad)
    _close(geometry.euler_to_matrix_xyz(te), mats)
    _close(geometry.matrix_to_euler_xyz(torch.from_numpy(np.array(mats))),
           jax_geo.matrix_to_euler_xyz(mats))
    d6 = rng.normal(size=(4, j, 6)).astype(np.float32)
    _close(geometry.rotation_6d_to_matrix(torch.from_numpy(d6)),
           jax_geo.rotation_6d_to_matrix(d6))
    _close(geometry.matrix_to_rotation_6d(torch.from_numpy(
        np.array(mats))), jax_geo.matrix_to_rotation_6d(mats))
    rep = geometry.euler_deg_to_6d(torch.from_numpy(euler_deg), j)
    _close(rep, jax_geo.euler_deg_to_6d(euler_deg, j))
    _close(geometry.rep6d_to_euler_deg(rep, j),
           jax_geo.rep6d_to_euler_deg(np.asarray(rep.numpy()), j))
    tree = [[0, 1, 2, 3], [0, 4, 5]]
    offsets = rng.normal(size=(j, 3)).astype(np.float32)
    root = rng.normal(size=(4, 3)).astype(np.float32)
    for root_r in (True, False):
        _close(geometry.forward_kinematics_euler(
            te, torch.from_numpy(root), offsets, tree, root_r),
            jax_geo.forward_kinematics_euler(e_rad, root, offsets, tree,
                                             root_r))
        _close(geometry.forward_kinematics_cont6d(
            torch.from_numpy(d6), torch.from_numpy(root), offsets, tree,
            root_r),
            jax_geo.forward_kinematics_cont6d(d6, root, offsets, tree,
                                              root_r))
