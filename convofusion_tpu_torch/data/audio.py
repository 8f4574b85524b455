"""Audio helpers.  Only ``save_wav`` is ported so far
(``convofusion_tpu/data/audio.py:217-226``): the rollout's result dump
writes the window's audio with it."""
from __future__ import annotations

import wave

import numpy as np


def save_wav(path: str, y: np.ndarray, sr: int = 16000):
    """Mono 16-bit PCM, samples clipped to [-1, 1]."""
    y16 = np.clip(np.asarray(y, np.float32), -1.0, 1.0)
    y16 = (y16 * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(y16.tobytes())
