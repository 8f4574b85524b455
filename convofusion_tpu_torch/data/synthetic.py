"""Synthetic batches with the shapes and dtypes of the real pipeline.

``synthetic_raw_batch``, ``synthetic_long_batch`` and their helpers are a
copy of ``convofusion_tpu/data/synthetic.py:14-106`` (numpy, seeded), so
both packages draw identical batches from one seed.  ``prepare_arrays`` mirrors
``:109-122`` with ``Convofusion.prepare_text_batch`` and returns torch tensors
on the model's device.
"""
from __future__ import annotations

import numpy as np

from convofusion_tpu_torch.models.convofusion import to_tensors

_WORDS = (
    "the quick brown fox jumps over a lazy dog while we talk about maps "
    "and dragons rolling dice around this table tonight with great joy"
).split()


def synthetic_texts(rng: np.random.Generator, batch: int,
                    min_words=3, max_words=12):
    return [
        " ".join(rng.choice(_WORDS,
                            size=rng.integers(min_words, max_words + 1)))
        for _ in range(batch)
    ]


def synthetic_motion(rng, batch: int, frames: int = 128, nfeats: int = 189,
                     scale: float = 0.3):
    """Smooth random trajectories, roughly matching canonicalized
    magnitudes (process_motion output, dataset.py:523-574)."""
    steps = rng.normal(size=(batch, frames, nfeats)).astype(np.float32)
    walk = np.cumsum(steps, axis=1) / np.sqrt(frames)
    kernel = np.ones(5, np.float32) / 5
    walk = np.apply_along_axis(
        lambda m: np.convolve(m, kernel, mode="same"), 1, walk)
    return (walk * scale).astype(np.float32)


def synthetic_melspec(rng, batch: int, frames: int = 161, n_mels: int = 80):
    """dB-scale mel spectrograms in [-80, 0] (power_to_db ref=max)."""
    base = rng.uniform(-80.0, -20.0, size=(batch, frames, n_mels))
    envelope = -40.0 * np.abs(
        np.sin(np.linspace(0, 6, frames)))[None, :, None]
    mel = np.maximum(base + envelope, -80.0)
    mel[:, :, :5] += 15.0
    return np.clip(mel, -80.0, 0.0).astype(np.float32)


def synthetic_raw_batch(seed: int, batch: int, frames: int = 128,
                        nfeats: int = 189, mel_frames: int = 161,
                        n_chunks: int = 8):
    rng = np.random.default_rng(seed)
    return {
        "motion_lsn": synthetic_motion(rng, batch, frames, nfeats),
        "motion_spk": synthetic_motion(rng, batch, frames, nfeats),
        "melspec_lsn": synthetic_melspec(rng, batch, mel_frames),
        "melspec_spk": synthetic_melspec(rng, batch, mel_frames),
        "text_spk": synthetic_texts(rng, batch),
        "text_lsn": synthetic_texts(rng, batch),
        "active_passive_lsn": rng.integers(
            0, 2, size=(batch, n_chunks)).astype(np.int32),
        "lsn_id": rng.integers(1, 36, size=(batch,)).astype(np.int32),
        "length": [frames] * batch,
    }


def synthetic_long_batch(seed: int, batch: int, n_parts: int = 3,
                         frames_per_part: int = 128, fps: int = 25,
                         sr: int = 16000, hop: int = 512):
    """Long-form batch for the rollout (``cli/unbounded.rollout``): (B,
    n_parts*128) motion/audio/mel/apb plus whisper-style word segments,
    like the 30 s utterance sets of the reference rollout."""
    rng = np.random.default_rng(seed)
    frames = frames_per_part * n_parts
    n_samples = int(frames / fps * sr)

    def segments():
        out = []
        for _ in range(batch):
            segs, t = [], 0.0
            while t < frames / fps - 1.0:
                dur = float(rng.uniform(0.2, 0.6))
                segs.append([[t, t + dur], str(rng.choice(_WORDS))])
                t += dur + float(rng.uniform(0.05, 0.8))
            out.append(segs)
        return out

    return {
        "motion_lsn": synthetic_motion(rng, batch, frames),
        "motion_spk": synthetic_motion(rng, batch, frames),
        "melspec_lsn": synthetic_melspec(rng, batch, n_samples // hop + 1),
        "melspec_spk": synthetic_melspec(rng, batch, n_samples // hop + 1),
        "active_passive_lsn": rng.integers(
            0, 2, (batch, 8 * n_parts)).astype(np.int32),
        "lsn_id": rng.integers(1, 36, size=(batch,)).astype(np.int32),
        "audio_lsn": rng.normal(size=(batch, n_samples)).astype(np.float32),
        "audio_spk": rng.normal(size=(batch, n_samples)).astype(np.float32),
        "seg_lsn": segments(),
        "seg_spk": segments(),
        "name": [f"synthetic/long_{i}" for i in range(batch)],
        "text_spk": synthetic_texts(rng, batch),
    }


def prepare_arrays(model, raw):
    """Raw (strings + numpy) batch -> dict of tensors on the model's
    device.  Integer arrays become int64 indices."""
    text_arrays, tb_spk, tb_lsn = model.prepare_text_batch(
        raw["text_spk"], raw["text_lsn"])
    arrays = {k: np.asarray(raw[k]) for k in (
        "motion_lsn", "motion_spk", "melspec_lsn", "melspec_spk",
        "active_passive_lsn", "lsn_id")}
    return to_tensors({**arrays, **text_arrays}, model.device), tb_spk, \
        tb_lsn
