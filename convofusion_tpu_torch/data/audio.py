"""Audio DSP: mel spectrograms, dB scaling, wav IO.

A numpy copy of ``convofusion_tpu/data/audio.py:29-230``, which
re-implements librosa 0.10's semantics as the reference uses them
(dataset.py:506-520: ``melspectrogram(sr=16000, hop_length=512,
n_mels=80)`` + ``power_to_db(ref=np.max)``; ``amplitude_to_db`` for the
active/passive bits; ``librosa.util.normalize``): a slaney-scale mel
filterbank, a centered zero-padded STFT with a periodic Hann window,
top_db=80 clamping.  ``melspectrogram`` runs the native C++ kernel
(``native/``) when it builds.  ``melspectrogram_batch`` and
``power_to_db_batch`` are the torch counterparts of JAX's two batch
functions, on the tensor's device (cuFFT and cuBLAS on the card).

Wav IO uses the stdlib ``wave`` module (8/16/32-bit PCM).
"""
from __future__ import annotations

import wave
from functools import lru_cache

import numpy as np
import torch

from convofusion_tpu_torch import native
from convofusion_tpu_torch.utils import profiling


# ----------------------------------------------------------------- mel scale
def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz)
        / logstep,
        mels,
    )


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=8)
def mel_filterbank(sr: int = 16000, n_fft: int = 2048, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalized triangular filters."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2),
        htk)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney norm
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=4)
def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)


# ----------------------------------------------------------------- stft / mel
def stft_power(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512
               ) -> np.ndarray:
    """|STFT|^2, centered with zero padding (librosa 0.10 defaults).

    y (n,) -> (n_frames, n_bins)."""
    pad = n_fft // 2
    yp = np.pad(y.astype(np.float32), (pad, pad))
    n_frames = 1 + (len(yp) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = yp[idx] * hann_window(n_fft)[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    return (spec.real**2 + spec.imag**2).astype(np.float32)


def melspectrogram(y: np.ndarray, sr: int = 16000, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 80) -> np.ndarray:
    """Power mel spectrogram, (n_frames, n_mels) — note the transpose vs
    librosa (the reference transposes immediately, dataset.py:517).

    Through the native C++ kernel (``native/``) when it is available —
    the same math, OpenMP over frames; numpy otherwise.
    ``profiling.COUNTS['melspec.native']`` and ``['melspec.numpy']``
    count the calls each path took."""
    fb = mel_filterbank(sr, n_fft, n_mels)
    out = native.melspec_power(np.asarray(y, np.float32), fb, n_fft,
                               hop_length)
    if out is not None:
        profiling.count("melspec.native")
        return out
    profiling.count("melspec.numpy")
    power = stft_power(y, n_fft, hop_length)
    return power @ fb.T


def power_to_db(s: np.ndarray, ref=None, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with ref=np.max semantics."""
    ref_value = np.max(s) if ref is None else ref
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.astype(np.float32)


def amplitude_to_db(a: np.ndarray, ref: float = 1.0, amin: float = 1e-5,
                    top_db: float = 80.0) -> np.ndarray:
    mag = np.abs(a)
    log_spec = 20.0 * np.log10(np.maximum(amin, mag))
    log_spec -= 20.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.astype(np.float32)


def normalize(y: np.ndarray) -> np.ndarray:
    """librosa.util.normalize: peak-normalize to max |y| = 1."""
    peak = np.max(np.abs(y))
    if peak > 0 and np.isfinite(peak):
        return (y / peak).astype(np.float32)
    return y.astype(np.float32)


def mel_db(y: np.ndarray, sr: int = 16000, hop_length: int = 512,
           n_mels: int = 80) -> np.ndarray:
    """The reference's get_melspecs per-audio path (dataset.py:506-520)."""
    return power_to_db(melspectrogram(y, sr, hop_length=hop_length,
                                      n_mels=n_mels))


# ---------------------------------------------------- batched torch mel path
def melspectrogram_batch(y: torch.Tensor, sr: int = 16000, n_fft: int = 2048,
                         hop_length: int = 512, n_mels: int = 80
                         ) -> torch.Tensor:
    """(B, n) -> (B, n_frames, n_mels) power mels on ``y``'s device (JAX
    ``melspectrogram_batch_jax``, :161-178): centered zero-padded frames by
    index, the periodic Hann window, ``torch.fft.rfft``, the filterbank as
    a matmul.  In fp32 (the JAX version's dtype)."""
    y = y.float()
    pad = n_fft // 2
    yp = torch.nn.functional.pad(y, (pad, pad))
    n_frames = 1 + (yp.shape[1] - n_fft) // hop_length
    idx = (torch.arange(n_fft, device=y.device)[None, :]
           + hop_length * torch.arange(n_frames, device=y.device)[:, None])
    window = torch.from_numpy(hann_window(n_fft)).to(y.device)
    spec = torch.fft.rfft(yp[:, idx] * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(y.device)
    return torch.matmul(power, fb.T)


def power_to_db_batch(s: torch.Tensor, amin: float = 1e-10,
                      top_db: float = 80.0) -> torch.Tensor:
    """``power_to_db`` per sample, the reference power the maximum over the
    trailing two axes (JAX ``power_to_db_jax``, :181-189)."""
    ref = s.amax(dim=(-2, -1), keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    return torch.maximum(log_spec,
                         log_spec.amax(dim=(-2, -1), keepdim=True) - top_db)


# --------------------------------------------------------------------- wav io
def load_wav(path: str, expected_sr: int | None = None):
    """PCM wav -> float32 in [-1, 1] (mono: channels averaged), linearly
    resampled to ``expected_sr`` where given."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2**31
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if expected_sr is not None and sr != expected_sr:
        data = resample_linear(data, sr, expected_sr)
        sr = expected_sr
    return data, sr


def save_wav(path: str, y: np.ndarray, sr: int = 16000):
    """Mono 16-bit PCM, samples clipped to [-1, 1]."""
    y16 = np.clip(np.asarray(y, np.float32), -1.0, 1.0)
    y16 = (y16 * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(y16.tobytes())


def resample_linear(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    n_out = int(round(len(y) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(y) - 1.0, n_out)
    return np.interp(x_out, np.arange(len(y)), y).astype(np.float32)
