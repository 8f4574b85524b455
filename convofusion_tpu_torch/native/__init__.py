"""Host C++ kernels for the data loader: the mel spectrogram.

The port's copy of ``convofusion_tpu/native/__init__.py``: ``melspec.cc``
computes the power mel of one signal (framing, periodic Hann window,
radix-2 FFT in double precision, filterbank) with OpenMP over frames.  It
is a CPU kernel reached through ctypes, not a device kernel.  It is built
with ``g++`` on first use into the package's ``_build/`` directory (keyed
by the source's hash) and always optional: ``data/audio.py`` falls back to
numpy when no compiler is available or ``CONVOFUSION_TPU_NATIVE=0`` is
set.  ``status()`` says which it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "melspec.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()
_lib = None
_tried = False
_why = "not built yet"


def _build() -> str | None:
    global _why
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libmelspec-{tag}.so")
    if os.path.exists(so):
        return so
    # a per-process temporary name, so concurrent builders cannot
    # interleave; os.replace is atomic
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        try:  # without OpenMP (minimal toolchains)
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        except Exception as e:
            _why = f"g++ failed: {e}"
            return None
    os.replace(tmp, so)
    return so


def load():
    """The ctypes handle to the library, or None where it is unavailable."""
    global _lib, _tried, _why
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("CONVOFUSION_TPU_NATIVE", "1") == "0":
            _why = "CONVOFUSION_TPU_NATIVE=0"
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.melspec_power.restype = ctypes.c_int
            lib.melspec_power.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
        except (OSError, AttributeError) as e:
            # an unloadable artifact (no libgomp, a corrupt file): drop it
            # and use numpy rather than crash the loader
            _why = f"load failed: {e}"
            try:
                os.unlink(so)
            except OSError:
                pass
            return None
        _lib = lib
        _why = f"built {os.path.basename(so)}"
    return _lib


def available() -> bool:
    return load() is not None


def status() -> str:
    """Why the native path is or is not in use."""
    load()
    return _why


def melspec_power(y: np.ndarray, fb: np.ndarray, n_fft: int,
                  hop_length: int) -> np.ndarray | None:
    """(n,) float32 signal -> (n_frames, n_mels) float32 power mel, what
    ``stft_power(y) @ fb.T`` computes (data/audio.py).  None if the library
    is unavailable."""
    lib = load()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, np.float32)
    fb = np.ascontiguousarray(fb, np.float32)
    n_mels, n_bins = fb.shape
    assert n_bins == n_fft // 2 + 1, (fb.shape, n_fft)
    pad = n_fft // 2
    n_frames = 1 + (len(y) + 2 * pad - n_fft) // hop_length
    if n_frames <= 0:
        return np.zeros((0, n_mels), np.float32)
    out = np.empty((n_frames, n_mels), np.float32)
    rc = lib.melspec_power(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(y),
        n_fft, hop_length, n_mels,
        fb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_frames)
    if rc != 0:
        return None
    return out
