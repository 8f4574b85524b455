"""The host tools (``convofusion_tpu_torch/scripts``) against JAX's
(``convofusion_tpu/scripts``) on ``tests/test_scripts.py``'s inputs and on
seeded ones, on the CPU:

- BVH: the parse equal; the float64 forward kinematics within 1e-9 on
  ``SIMPLE_BVH``, on the flat-chain BEAT file and on a seeded BEAT-skeleton
  tree with rotations within +-30 degrees; the float32 joint positions
  within 1e-6 relative; ``beat_getjoints.main`` over a speaker directory
  with one corrupt file skipped as JAX skips it.
- Silence: the ranges of ``detect_silence`` / ``detect_nonsilent`` /
  ``split_on_silence`` equal, the ``seek_step=7`` pin included, and the
  segments equal.
- Utterance sets: ``process_session`` with ``NullTranscriber`` writes the
  same tree, every file byte-equal.
- Transcription stubs and visualisation: the same files (the contact sheet
  decodes to the same pixels).
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from convofusion_tpu.data.audio import save_wav as jax_save_wav
from convofusion_tpu.scripts import beat_getjoints as jax_joints
from convofusion_tpu.scripts import bvh as jax_bvh
from convofusion_tpu.scripts import make_utterance_dataset as jax_utt
from convofusion_tpu.scripts import silence as jax_silence
from convofusion_tpu.scripts import transcribe as jax_transcribe
from convofusion_tpu.scripts import visualize as jax_visualize
from convofusion_tpu_torch.scripts import beat_getjoints, bvh
from convofusion_tpu_torch.scripts import make_utterance_dataset as utt
from convofusion_tpu_torch.scripts import silence, synthetic, transcribe
from convofusion_tpu_torch.scripts import visualize

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_scripts import SIMPLE_BVH  # noqa: E402

FK_ATOL = 1e-9
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_chain_bvh(path, frames=3, seed=None):
    """``test_scripts.test_beat_getjoints_over_fixture_bvh``'s file: every
    joint JOINT_LIST needs as one flat chain (zero motion, or seeded)."""
    needed = [j for j in dict.fromkeys(jax_joints.JOINT_LIST)
              if not j.endswith("Mid") and not j.endswith("End")]
    lines = ["HIERARCHY", "ROOT Hips", "{", "OFFSET 0 0 0",
             "CHANNELS 6 Xposition Yposition Zposition "
             "Zrotation Xrotation Yrotation"]
    for j in needed + ["HeadEnd", "LeftToeBaseEnd", "RightToeBaseEnd"]:
        lines += [f"JOINT {j}", "{", "OFFSET 0 1 0",
                  "CHANNELS 3 Zrotation Xrotation Yrotation"]
    lines += ["End Site", "{", "OFFSET 0 1 0", "}"]
    lines += ["}"] * (len(needed) + 3 + 1)
    n_channels = 6 + 3 * (len(needed) + 3)
    values = np.zeros((frames, n_channels)) if seed is None else \
        np.random.default_rng(seed).uniform(-30, 30, (frames, n_channels))
    lines += ["MOTION", f"Frames: {frames}", "Frame Time: 0.00833"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in values]
    path.write_text("\n".join(lines))
    return str(path)


def _same_parse(path):
    a, b = bvh.parse_bvh(path), jax_bvh.parse_bvh(path)
    assert a.joint_names == b.joint_names and a.frame_time == b.frame_time
    np.testing.assert_array_equal(a.frames, b.frames)
    for ja, jb in zip(a.joints, b.joints):
        assert (ja.parent, ja.channels, ja.channel_start) == \
            (jb.parent, jb.channels, jb.channel_start)
        np.testing.assert_array_equal(ja.offset, jb.offset)
    return a, b


@pytest.mark.parametrize("kind", ["simple", "flat", "flat_moving", "tree"])
def test_forward_kinematics_equal_jax(tmp_path, kind):
    path = tmp_path / "t.bvh"
    if kind == "simple":
        path.write_text(SIMPLE_BVH)
        path = str(path)
    elif kind == "tree":
        path = synthetic.write_beat_bvh(str(path), 240, seed=7)
    else:
        path = flat_chain_bvh(path, 5, None if kind == "flat" else 3)
    a, b = _same_parse(path)
    pos, names = bvh.world_positions(a, CPU)
    want, want_names = jax_bvh.world_positions(b)
    assert names == want_names and pos.dtype == torch.float64
    np.testing.assert_allclose(pos.numpy(), want, rtol=0, atol=FK_ATOL)
    by_name = bvh.positions_by_name(a, CPU)
    for name, p in jax_bvh.positions_by_name(b).items():
        np.testing.assert_allclose(by_name[name].numpy(), p, atol=FK_ATOL)
    if kind != "simple":
        got = beat_getjoints.bvh_to_joint_positions(path, CPU)
        ref = jax_joints.bvh_to_joint_positions(path)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_rotation_matrices_are_jaxs_single_axis_builds():
    deg = np.random.default_rng(2).uniform(-180, 180, (6, 3))
    axes = ["Z", "X", "Y"]
    got = bvh.rotation_matrices(axes, torch.from_numpy(deg))
    for k, axis in enumerate(axes):
        np.testing.assert_allclose(got[:, k].numpy(),
                                   jax_bvh._rot_single_axis(axis, deg[:, k]),
                                   rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="rotation axes"):
        bvh.rotation_matrices(["W"], torch.zeros(2, 1))


def test_a_malformed_file_raises_value_error(tmp_path):
    p = tmp_path / "bad.bvh"
    p.write_text(SIMPLE_BVH.replace("HIERARCHY", "HIERARCHIE"))
    with pytest.raises(ValueError, match="HIERARCHY"):
        bvh.parse_bvh(str(p))


def test_convert_speakers_skips_a_corrupt_file_as_jax(tmp_path, capsys):
    for root in ("port", "jax"):
        spk = tmp_path / root / "beat" / "2"
        spk.mkdir(parents=True)
        synthetic.write_beat_bvh(str(spk / "a.bvh"), 30, seed=1)
        flat_chain_bvh(spk / "b.bvh", 4, 2)
        text = (spk / "a.bvh").read_text()
        (spk / "c.bvh").write_text(text[:len(text) - 200])   # truncated
    beat_getjoints.main(["--beat_path", str(tmp_path / "port" / "beat"),
                         "--out_path", str(tmp_path / "port" / "out"),
                         "--speakers", "3", "--device", CPU])
    out = capsys.readouterr().out
    jax_joints.main(["--beat_path", str(tmp_path / "jax" / "beat"),
                     "--out_path", str(tmp_path / "jax" / "out"),
                     "--speakers", "3"])
    assert "speaker 2: converted 2 files" in out and "c.bvh" in out
    port_files = sorted(os.listdir(tmp_path / "port" / "out" / "2"))
    assert port_files == sorted(os.listdir(tmp_path / "jax" / "out" / "2"))
    assert port_files == ["a.npy", "b.npy"]
    for f in port_files:
        np.testing.assert_allclose(
            np.load(tmp_path / "port" / "out" / "2" / f),
            np.load(tmp_path / "jax" / "out" / "2" / f), rtol=1e-6,
            atol=1e-6)
    # a second pass converts nothing: the outputs exist
    assert beat_getjoints.convert_speaker(
        str(tmp_path / "port" / "beat" / "2"),
        str(tmp_path / "port" / "out" / "2"), CPU) == 0


def _roundtrip_signal(sr=16000):
    quiet = np.zeros(sr, np.float32)
    loud = 0.5 * np.sin(
        2 * np.pi * 220 * np.arange(sr * 2) / sr).astype(np.float32)
    return np.concatenate([quiet, loud, quiet, quiet])


def _pin_signal(sr=16000):
    loud = 0.5 * np.sin(
        2 * np.pi * 220 * np.arange(int(sr * 0.6)) / sr).astype(np.float32)
    return np.concatenate([loud, np.zeros(int(sr * 0.4), np.float32)])


def _bursts(seed, seconds=20, sr=16000):
    rng = np.random.default_rng(seed)
    y = np.zeros(seconds * sr, np.float32)
    t = 0
    while t < len(y):
        n = int(rng.uniform(0.05, 3) * sr)
        y[t:t + n] = rng.uniform(0.001, 0.5) * np.sin(
            2 * np.pi * rng.uniform(80, 400) * np.arange(len(y[t:t + n]))
            / sr)
        t += n + int(rng.uniform(0.05, 2) * sr)
    return y + rng.normal(0, 1e-4, len(y)).astype(np.float32)


@pytest.mark.parametrize("signal,kw", [
    (_roundtrip_signal(), dict(min_silence_len=500, silence_thresh=-45)),
    (_pin_signal(), dict(min_silence_len=300, silence_thresh=-45,
                         seek_step=7)),
    (_bursts(0), dict(min_silence_len=1000, silence_thresh=-45)),
    (_bursts(1), dict(min_silence_len=200, silence_thresh=-40,
                      seek_step=3)),
    (_bursts(2), dict(min_silence_len=100, silence_thresh=-30,
                      seek_step=10)),
    (np.zeros(800, np.float32), dict(min_silence_len=100)),
])
def test_silence_ranges_equal_jax(signal, kw):
    sr = 16000
    assert silence.detect_silence(signal, sr, device=CPU, **kw) == \
        jax_silence.detect_silence(signal, sr, **kw)
    assert silence.detect_nonsilent(signal, sr, device=CPU, **kw) == \
        jax_silence.detect_nonsilent(signal, sr, **kw)
    segs, ranges = silence.split_on_silence(signal, sr, keep_silence=10,
                                            device=CPU, **kw)
    want_segs, want = jax_silence.split_on_silence(signal, sr,
                                                   keep_silence=10, **kw)
    assert ranges == want and len(segs) == len(want_segs)
    for a, b in zip(segs, want_segs):
        np.testing.assert_array_equal(a, b)
    if kw.get("seek_step") == 7:       # the final window start analysed
        assert ranges and silence.detect_silence(
            signal, sr, device=CPU, **kw)[0][1] == 1000


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("session", ["test_scripts", "bursts"])
def test_utterance_sets_byte_equal_jax(tmp_path, session):
    sess = tmp_path / "sessions" / "game1"
    if session == "bursts":
        synthetic.write_session(str(sess), 40, seed=5)
    else:                        # test_scripts.test_make_utterance_dataset
        sr, fps, seconds = 16000, 25, 12
        rng = np.random.default_rng(0)
        sess.mkdir(parents=True)
        for p in range(5):
            y = (0.4 * np.sin(2 * np.pi * 200 * np.arange(seconds * sr) / sr)
                 if p == 0 else np.zeros(seconds * sr)).astype(np.float32)
            jax_save_wav(str(sess / f"person_{p}.wav"), y, sr)
            np.save(sess / f"person_{p}.npy",
                    rng.normal(size=(seconds * fps, 67, 3)).astype(
                        np.float32))
    n = utt.process_session(str(sess), str(tmp_path / "port"),
                            transcriber=transcribe.NullTranscriber(),
                            device=CPU)
    want = jax_utt.process_session(
        str(sess), str(tmp_path / "jax"),
        transcriber=jax_transcribe.NullTranscriber())
    assert n == want and n >= 2
    got, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(ref)
    assert {os.path.splitext(k)[1] for k in got} == {".npy", ".wav", ".txt"}
    for k in ref:
        assert got[k] == ref[k], k
    # the CLI over the session directory writes the same sets
    assert utt.main(["--sessions", str(tmp_path / "sessions"), "--out",
                     str(tmp_path / "cli"), "--device", CPU]) == n
    assert _files(tmp_path / "cli") == got


def test_transcription_stubs_equal_jax(tmp_path):
    words = [(0.0, 0.4, "hello"), (0.5, 0.9, ""), (1.0, 1.6, "there")]
    for side, mod in (("port", transcribe), ("jax", jax_transcribe)):
        d = tmp_path / side
        d.mkdir()
        mod.write_word_segments(str(d / "seg_words.txt"), words)
        mod.write_word_segments(str(d / "seg_empty.txt"), [])
        src = d / "beat" / "2_scott"
        src.mkdir(parents=True)
        y = np.sin(np.arange(8000) / 7.0).astype(np.float32)
        jax_save_wav(str(src / "a.wav"), y, 16000)
        mod.transcribe_tree(str(d / "beat"), str(d / "json"),
                            mod.NullTranscriber())
        sets = d / "dnd" / "game" / "set_0000_p0"
        sets.mkdir(parents=True)
        jax_save_wav(str(sets / "audio_spk.wav"), y, 16000)
        jax_save_wav(str(sets / "audio_lsn1.wav"), y, 16000)
        mod.create_word_segments(str(d / "dnd"), mod.NullTranscriber())
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (tmp_path / "port" / "dnd" / "game" / "set_0000_p0" /
            "seg_lsn1.txt").read_text() == "0.0\t0.0\t-\n"
    # no whisper on this machine: both fall back to the stub
    assert type(transcribe.default_transcriber()).__name__ == \
        type(jax_transcribe.default_transcriber()).__name__ == \
        "NullTranscriber"


def test_render_clip_png_equal_jax(tmp_path):
    import matplotlib.image

    joints = np.random.default_rng(1).normal(size=(16, 63, 3)).astype(
        np.float32)
    got = visualize.render_clip(joints, str(tmp_path / "port.png"))
    want = jax_visualize.render_clip(joints, str(tmp_path / "jax.png"))
    assert os.path.getsize(got) > 1000
    np.testing.assert_array_equal(matplotlib.image.imread(got),
                                  matplotlib.image.imread(want))
    # the CLI on a (T, J*3) dump; without ffmpeg the mux is skipped
    np.save(tmp_path / "pred.npy", joints.reshape(16, -1))
    out = visualize.main(["--npy", str(tmp_path / "pred.npy"), "--out",
                          str(tmp_path / "cli.png")])
    np.testing.assert_array_equal(matplotlib.image.imread(out),
                                  matplotlib.image.imread(want))
    if shutil.which("ffmpeg") is None:
        assert visualize.mux_audio(out, "missing.wav", "x.mp4") == out
