"""The one traffic generator: seeded host batches from a traffic file's
parameters.

The makers of texts, motion and mel spectrograms are frozen copies of the
program's synthetic batch makers (``data/synthetic.py``): random walks
smoothed over 5 frames for motion, dB-scale mels in [-80, 0], 3-12 words
of a small vocabulary for texts.  A later change to the program cannot
move them.  Batch ``i`` of a run draws from ``numpy.random.default_rng(
[seed, i])``, so one seed gives the same batches on every run and any
seed, however large, is taken whole.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

WORDS = (
    "the quick brown fox jumps over a lazy dog while we talk about maps "
    "and dragons rolling dice around this table tonight with great joy"
).split()


def synthetic_texts(rng, batch: int, min_words: int = 3, max_words: int = 12):
    return [" ".join(rng.choice(WORDS, size=rng.integers(min_words,
                                                         max_words + 1)))
            for _ in range(batch)]


def synthetic_motion(rng, batch: int, frames: int = 128, nfeats: int = 189,
                     scale: float = 0.3):
    steps = rng.normal(size=(batch, frames, nfeats)).astype(np.float32)
    walk = np.cumsum(steps, axis=1) / np.sqrt(frames)
    # a 5-frame moving average, zero-padded at both ends
    pad = np.pad(walk, ((0, 0), (2, 2), (0, 0)))
    smooth = sum(pad[:, k:k + frames] for k in range(5)) / 5
    return (smooth * scale).astype(np.float32)


def synthetic_melspec(rng, batch: int, frames: int = 161, n_mels: int = 80):
    base = rng.uniform(-80.0, -20.0, size=(batch, frames, n_mels))
    envelope = -40.0 * np.abs(np.sin(np.linspace(0, 6, frames)))[None, :,
                                                                  None]
    mel = np.maximum(base + envelope, -80.0)
    mel[:, :, :5] += 15.0
    return np.clip(mel, -80.0, 0.0).astype(np.float32)


def focus_words(texts, rng, no_focus_every: int):
    """1-3 distinct words of each text; every ``no_focus_every``-th text
    none."""
    out = []
    for i, text in enumerate(texts):
        words = sorted(set(text.split()))
        if i % no_focus_every == no_focus_every - 1:
            out.append(())
            continue
        k = min(int(rng.integers(1, 4)), len(words))
        out.append(tuple(str(w) for w in rng.choice(words, size=k,
                                                     replace=False)))
    return out


def batch(params: Dict, seed: int, index: int) -> Dict:
    """Host batch ``index`` of a run with ``seed``: the fields that
    ``params['fields']`` names, ``params['batch']`` rows each."""
    rng = np.random.default_rng([int(seed), int(index)])
    b = int(params["batch"])
    out = {}
    for field in params["fields"]:
        if field == "motion":
            out["motion"] = synthetic_motion(rng, b, int(params["frames"]),
                                             int(params["nfeats"]))
        elif field == "mel":
            out["mel"] = synthetic_melspec(rng, b, int(params["mel_frames"]),
                                           int(params["n_mels"]))
        elif field == "texts":
            lo, hi = params["words"]
            out["text_spk"] = synthetic_texts(rng, b, lo, hi)
            out["text_lsn"] = synthetic_texts(rng, b, lo, hi)
        elif field == "apb":
            out["apb"] = rng.integers(0, 2, size=(b, int(params["n_chunks"])
                                                  )).astype(np.int32)
        elif field == "lsn_id":
            lo, hi = params["lsn_ids"]
            out["lsn_id"] = rng.integers(lo, hi + 1, size=(b,)).astype(
                np.int32)
        elif field == "focus":
            out["focus"] = focus_words(out["text_lsn"], rng,
                                       int(params["no_focus_every"]))
        else:
            raise ValueError(f"traffic field {field!r}")
    return out


def batches(params: Dict, seed: int) -> List[Dict]:
    """The run's pool of ``params['pool']`` distinct batches, which the
    driver cycles through."""
    return [batch(params, seed, i) for i in range(int(params["pool"]))]
