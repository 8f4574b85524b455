"""On-disk synthetic dataset trees in the reference's layout.

A copy of ``convofusion_tpu/data/fixture.py:1-244``: BEAT-style trees
(speaker directories of 120 fps joint .npy, .wav, .TextGrid and semantic
.txt) and DnD-style trees (5-person utterance sets), the same bytes from
the same seeds, so the data pipeline — loaders, canonicalization,
featurization — runs end to end without the real datasets (which the
reference does not ship either, datasets/DATASETS.md).
"""
from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np

from convofusion_tpu_torch.data.audio import save_wav
from convofusion_tpu_torch.data.text import write_textgrid

_WORDS = ("hello there friend this is a story about brave knights and "
          "dragons we roll dice and laugh together all night").split()


# shared low-rank generator state for mode='lowrank' (fixed seed on
# purpose: the rest pose, mixing basis and temporal modes are common to
# every clip, so per-clip information is ONLY the (R, K) mode
# coefficients — see _skeleton_motion)
# R*2K must stay <= a single chunk's token capacity in the overfit
# preset (2 tokens x 32 dims = 64): a BEAT window starting at offset t0
# sees sin(2pi f (t+t0) + phi) = a sin/cos pair per mode, so per-window
# information is at most R*2K coefficients (here 32)
_LOWRANK_R = 4   # mixing rank
_LOWRANK_K = 4   # temporal modes
_LOWRANK_AMP = 3200.0  # drift amplitude in mm-basis units (see below)


def _lowrank_globals(njoints: int):
    g = np.random.default_rng(20260819)
    base = g.uniform(-400, 400, size=(1, njoints, 3))
    base[0, :, 1] = g.uniform(800, 1600, size=njoints)  # above floor
    # the canonicalization (data/dataset.py::process_motion) derives a
    # per-clip face-Z+ rotation from frame-0 hips/shoulders (raw joints
    # 18/13/9/5 -> same indices after the 67->63 cut) and a floor height
    # from the min joint; with a fully random rest pose the hip+shoulder
    # "across" axis can be near-vertical, making the facing rotation
    # chaotically sensitive to the per-clip drift — the shared rest pose
    # then lands rotated differently in every clip (cross-clip std ~4x
    # the motion std), which is per-clip information the fixture never
    # budgeted.  Structure those joints so the rotation is
    # well-conditioned (wide horizontal across axis => tiny per-clip
    # angle) and pin root + floor for stability:
    base[0, 18] = (-350.0, 950.0, 0.0)    # r_hip
    base[0, 13] = (350.0, 950.0, 0.0)     # l_hip
    base[0, 9] = (-450.0, 1400.0, 0.0)    # r_shoulder
    base[0, 5] = (450.0, 1400.0, 0.0)     # l_shoulder
    base[0, 0] = (0.0, 1000.0, 0.0)       # root
    base[0, 20, 1] = 50.0                 # stable floor-min joint
    mix = g.normal(size=(njoints * 3, _LOWRANK_R))
    # static root and floor joint: the VAE destroys per-chunk root-xz
    # offsets by construction (encode normalization) and the floor
    # subtraction keys on the min joint — drift on either would add
    # irreducible error / per-clip jitter the overfit can't remove
    mix[0 * 3:1 * 3] = 0.0
    mix[20 * 3:21 * 3] = 0.0
    mix /= np.linalg.norm(mix, axis=0, keepdims=True)
    freqs = g.uniform(0.3, 1.2, size=_LOWRANK_K)        # Hz
    phase = g.uniform(0, 2 * np.pi, size=_LOWRANK_K)
    return base, mix, freqs, phase


def _skeleton_motion(rng, frames: int, njoints: int = 67,
                     scale_mm: float = 100.0, mode: str = "walk",
                     fps: float = 120.0):
    """Plausible joint trajectories in mm: static offsets + motion.

    mode='walk': random-walk drift — good for exercising the pipeline,
    but spectrally flat (incompressible), so the chunked VAE *cannot*
    reconstruct it well by design.  mode='smooth': band-limited
    sum-of-sinusoids (0.2-2 Hz) — gesture-like, but with independent
    frequencies per joint-axis it still carries O(njoints*3*modes) ≈ 600+
    degrees of freedom per chunk, far above the chunked VAE's
    2-token/chunk bottleneck, so "recon near zero" is information-
    theoretically impossible.  mode='lowrank': every clip is
    base + mix @ B @ S(t) where the rest pose `base`, the (201, R)
    mixing basis `mix` and the K continuous-time sinusoid modes S are
    FIXED across clips; only the (R, K) coefficient matrix B is drawn
    per clip.  Per-clip information = R*K = 16 numbers — below even a
    single chunk's token capacity in the overfit preset (2 tokens x
    32 dims), so a correct model CAN drive recon to ~zero.  Used by the
    learning-loop overfit (train/overfit.py).
    """
    if mode == "lowrank":
        base, mix, freqs, phase = _lowrank_globals(njoints)
        t = np.arange(frames) / fps
        modes = np.sin(2 * np.pi * freqs[:, None] * t[None]
                       + phase[:, None])            # (K, frames)
        coef = rng.normal(size=(_LOWRANK_R, _LOWRANK_K))
        # amplitude: canonicalized per-clip motion lands at std ~2.0.
        # Measured escape dynamics (TPU diag, shipped loss, lr 1e-3,
        # full-batch): every variant — including a KL-free pure
        # autoencoder — sits in a mean-prediction saddle for ~800 steps
        # (the decoder fits the shared rest pose first and only then
        # discovers the latent); what the amplitude sets is the
        # steepness of the escape, because the encoder's recon gradient
        # must clear the unit-variance reparameterization noise floor.
        # At std ~0.5 (amp 800) the sampled VAE needs >5k steps
        # (relRMSE 0.81-0.97 @ 2k); at std ~2.0 (amp 3200) the shipped
        # recipe reaches relRMSE 0.12 @ 2k steps and keeps descending.
        # (Round 4 additionally shipped the BEAT write-side layout bug —
        # see _to_beat_file_layout — which scrambled joints and inflated
        # the canonical std to ~5.3 with per-clip static poses, the
        # round-4 "doesn't learn" finding.)
        drift = (mix @ coef @ modes) * _LOWRANK_AMP
        drift = drift.T.reshape(frames, njoints, 3)
        return (base + drift).astype(np.float32)
    base = rng.uniform(-400, 400, size=(1, njoints, 3))
    base[0, :, 1] = rng.uniform(800, 1600, size=njoints)  # above floor
    if mode == "smooth":
        t = np.arange(frames)[:, None, None, None] / fps
        freqs = rng.uniform(0.2, 2.0, size=(1, njoints, 3, 4))
        phase = rng.uniform(0, 2 * np.pi, size=(1, njoints, 3, 4))
        amp = rng.uniform(5, 60, size=(1, njoints, 3, 4)) / (1 + freqs)
        drift = (amp * np.sin(2 * np.pi * freqs * t + phase)).sum(-1)
    else:
        drift = np.cumsum(
            rng.normal(scale=scale_mm / 50, size=(frames, njoints, 3)),
            axis=0)
    return (base + drift).astype(np.float32)


def _to_beat_file_layout(motion_mm: np.ndarray) -> np.ndarray:
    """Write-side inverse of the BEAT loader contract: the loader
    reorders joints root-first ([3,0,1,2,4,...]) and converts cm->mm
    (x10) (data/dataset.py:234-236, reference dataset.py:161-162), so a
    BEAT .npy holding the same skeleton as a DnD .npy (mm, root at 0)
    must be stored permuted [1,2,3,0,4,...] and in cm.  Without this the
    BEAT fixture clips land 10x the DnD scale with scrambled face-joint
    indices, and the canonicalized static pose stops being shared across
    the two sources."""
    idx = [1, 2, 3, 0] + list(range(4, motion_mm.shape[1]))
    return (motion_mm[:, idx] / 10.0).astype(np.float32)


def _speech_audio(rng, n_samples: int, sr: int, active: bool = True):
    if not active:
        return np.zeros(n_samples, np.float32)
    t = np.arange(n_samples) / sr
    env = (np.sin(2 * np.pi * 2.3 * t) > 0).astype(np.float32)
    carrier = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(
        size=n_samples)
    return (env * carrier).astype(np.float32)


def make_beat_fixture(root: str, speakers=("2_scott", "4_lawrence"),
                      n_files: int = 1, fps: int = 120, sr: int = 16000,
                      seconds: float = 11.0, seed: int = 0,
                      motion_mode: str = "walk", words=_WORDS):
    """BEAT tree: <root>/<spkid>/<name>.{npy,wav,TextGrid,txt} + splits;
    the transcripts draw from ``words`` (UTF-8)."""
    rng = np.random.default_rng(seed)
    names = []
    for spk in speakers:
        spk_id = spk.split("_")[0]
        d = pjoin(root, spk_id)
        os.makedirs(d, exist_ok=True)
        for i in range(n_files):
            name = f"{spk_id}_{spk.split('_')[1]}_0_{i}_{i}"
            frames = int(seconds * fps)
            np.save(pjoin(d, name + ".npy"),
                    _to_beat_file_layout(
                        _skeleton_motion(rng, frames, mode=motion_mode,
                                         fps=fps)))
            n_samples = int(seconds * sr)
            save_wav(pjoin(d, name + ".wav"),
                     _speech_audio(rng, n_samples, sr), sr)
            # word-aligned TextGrid covering the clip
            n_words = 24
            bounds = np.linspace(0, seconds, n_words + 1)
            clip_words = [str(rng.choice(words)) for _ in range(n_words)]
            write_textgrid(pjoin(d, name + ".TextGrid"), clip_words,
                           bounds[:-1], bounds[1:], seconds)
            # semantic annotation tsv: name, start, end, duration, score,
            # keywords
            with open(pjoin(d, name + ".txt"), "w", encoding="utf-8") as f:
                for k in range(0, n_words, 4):
                    cls = "beat_align" if k % 8 else "iconic_gesture"
                    f.write(f"{cls}\t{bounds[k]:.2f}\t{bounds[k + 1]:.2f}\t"
                            f"{bounds[k + 1] - bounds[k]:.2f}\t0.7\t"
                            f"{clip_words[k]}\n")
            names.append(name)
    for split in ("train", "val", "test"):
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names))
    return names


def make_dnd_fixture(root: str, n_sets: int = 2, frames: int = 128,
                     fps: int = 25, sr: int = 16000, seed: int = 1,
                     motion_mode: str = "walk"):
    """DnD utterance-set tree: <root>/<session>/<set>/motion_*.npy etc."""
    rng = np.random.default_rng(seed)
    seconds = frames / fps
    n_samples = int(seconds * sr)
    set_names = []
    session = "session1_anne"  # speaker name embedded in path
    for i in range(n_sets):
        set_name = f"{session}/set_{i:03d}"
        d = pjoin(root, set_name)
        os.makedirs(d, exist_ok=True)
        np.save(pjoin(d, "motion_spk.npy"),
                _skeleton_motion(rng, frames, mode=motion_mode, fps=fps))
        save_wav(pjoin(d, "audio_spk.wav"),
                 _speech_audio(rng, n_samples, sr), sr)
        with open(pjoin(d, "text_spk.txt"), "w") as f:
            f.write(" ".join(rng.choice(_WORDS, size=8)))
        for li in range(1, 5):
            np.save(pjoin(d, f"motion_lsn{li}.npy"),
                    _skeleton_motion(rng, frames, mode=motion_mode,
                                     fps=fps))
            active = li % 2 == 1
            save_wav(pjoin(d, f"audio_lsn{li}.wav"),
                     _speech_audio(rng, n_samples, sr, active), sr)
            with open(pjoin(d, f"text_lsn{li}.txt"), "w") as f:
                f.write(" ".join(rng.choice(_WORDS, size=6))
                        if active else "")
            with open(pjoin(d, f"seg_lsn{li}.txt"), "w") as f:
                if active:
                    f.write("0.0\t1.0\thello\n1.0\t2.5\tthere\n")
        with open(pjoin(d, "seg_spk.txt"), "w") as f:
            f.write("0.0\t2.0\tonce\n2.0\t4.0\tupon\n")
        set_names.append(set_name)
    for split in ("train", "val", "test"):
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(set_names))
    return set_names


def make_fixture_pair(tmpdir: str, **kw):
    beat_root = pjoin(tmpdir, "beat")
    dnd_root = pjoin(tmpdir, "dnd")
    os.makedirs(beat_root, exist_ok=True)
    os.makedirs(dnd_root, exist_ok=True)
    make_beat_fixture(beat_root, **{k: v for k, v in kw.items()
                                    if k in ("n_files", "seed", "words")})
    make_dnd_fixture(dnd_root)
    return beat_root, dnd_root
