"""Audio onset detection (librosa-0.10 semantics, numpy only).

A numpy copy of ``convofusion_tpu/eval/onsets.py:13-128`` over the port's
``data/audio.py``.  The reference (quant_eval/metric_eval.py:93-122) takes
audio beats for the GAHR alignment metric from librosa's onset_strength /
onset_detect / onset_backtrack / rms chain; this module reproduces those
algorithms: a spectral-flux onset envelope over a 128-mel dB spectrogram,
peak picking with librosa's default windows, and backtracking to the
preceding energy minimum.
"""
from __future__ import annotations

import numpy as np

from convofusion_tpu_torch.data.audio import (
    melspectrogram,
    power_to_db,
    stft_power,
)


def onset_strength(y: np.ndarray, sr: int = 16000, hop_length: int = 512,
                   n_fft: int = 2048, n_mels: int = 128,
                   lag: int = 1) -> np.ndarray:
    """Spectral flux over dB mel spectrogram (librosa.onset.onset_strength)."""
    s = power_to_db(melspectrogram(y, sr, n_fft, hop_length, n_mels),
                    ref=None).T  # (mels, frames)
    diff = np.maximum(0.0, s[:, lag:] - s[:, :-lag])
    env = np.mean(diff, axis=0)
    pad_width = lag + n_fft // (2 * hop_length)  # centered frames
    env = np.pad(env, (int(pad_width), 0), mode="constant")
    return env[: s.shape[1]]


def peak_pick(x: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, delta: float, wait: int) -> np.ndarray:
    """librosa.util.peak_pick."""
    n = len(x)
    peaks = []
    last = -1 - wait
    for i in range(n):
        lo_m, hi_m = max(0, i - pre_max), min(n, i + post_max)
        if x[i] != np.max(x[lo_m:hi_m]):
            continue
        lo_a, hi_a = max(0, i - pre_avg), min(n, i + post_avg)
        if x[i] < np.mean(x[lo_a:hi_a]) + delta:
            continue
        if i - last <= wait:
            continue
        last = i
        peaks.append(i)
    return np.asarray(peaks, dtype=int)


def onset_detect(onset_envelope: np.ndarray, sr: int = 22050,
                 hop_length: int = 512) -> np.ndarray:
    """librosa.onset.onset_detect defaults (pre/post windows in frames).

    NB the reference calls ``onset_detect(onset_envelope=...)`` with no
    ``sr`` (metric_eval.py:112-114), so the peak-pick windows come from
    librosa's DEFAULT sr=22050 even though the envelope was computed at
    16 kHz — pre_max 1, post_max 1, pre_avg 4, post_avg 5, wait 1.
    Like the ``frames_to_time`` quirk below, this is part of the
    published metric and replicated by defaulting ``sr`` to 22050 here
    regardless of the audio's rate."""
    env = onset_envelope
    if env.size == 0 or not np.any(env):
        return np.asarray([], dtype=int)
    # librosa normalizes the envelope before peak picking
    env = env - env.min()
    if env.max() > 0:
        env = env / env.max()
    pre_max = int(0.03 * sr // hop_length)
    post_max = int(0.00 * sr // hop_length + 1)
    pre_avg = int(0.10 * sr // hop_length)
    post_avg = int(0.10 * sr // hop_length + 1)
    wait = int(0.03 * sr // hop_length)
    return peak_pick(env, max(pre_max, 1), post_max, max(pre_avg, 1),
                     post_avg, 0.07, wait)


def onset_backtrack(events: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Roll onsets back to the preceding local minimum
    (librosa.onset.onset_backtrack)."""
    if len(events) == 0:
        return events
    minima = np.flatnonzero(
        (energy[1:-1] <= energy[:-2]) & (energy[1:-1] < energy[2:])) + 1
    minima = np.concatenate([[0], minima]) if (len(minima) == 0
                                               or minima[0] != 0) else minima
    out = np.empty_like(events)
    for i, e in enumerate(events):
        prior = minima[minima <= e]
        out[i] = prior[-1] if len(prior) else 0
    return out


def rms_energy(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512
               ) -> np.ndarray:
    """RMS per frame from the power spectrogram (librosa.feature.rms(S=S));
    used only as backtracking energy, so the absolute scale is irrelevant."""
    power = stft_power(y, n_fft, hop_length)  # (frames, bins)
    x = power.copy()
    x[:, 0] *= 0.5
    x[:, -1] *= 0.5
    return np.sqrt(2.0 * np.sum(x, axis=1) / float(n_fft) ** 2)


def audio_beats(y: np.ndarray, sr: int = 16000, hop_length: int = 512):
    """The metric_eval.load_audio chain: (onset_raw, onset_bt,
    onset_bt_rms) frame indices, or (None, None, None) when silent."""
    env = onset_strength(y, sr, hop_length)
    # windows from librosa's default sr=22050, NOT the audio sr (the
    # reference passes no sr to onset_detect — see onset_detect's note)
    onset_raw = onset_detect(env, hop_length=hop_length)
    if len(onset_raw) == 0:
        return None, None, None
    onset_bt = onset_backtrack(onset_raw, env)
    rms = rms_energy(y, hop_length=hop_length)
    onset_bt_rms = onset_backtrack(onset_raw, rms)
    return onset_raw, onset_bt, onset_bt_rms


def frames_to_time(frames: np.ndarray, sr: int = 22050,
                   hop_length: int = 512) -> np.ndarray:
    """NB: the reference calls librosa.frames_to_time with DEFAULT sr=22050
    even though onsets were computed at 16 kHz (metric_eval.py:289) — this
    quirk is part of the published metric and replicated here."""
    return np.asarray(frames) * hop_length / float(sr)
