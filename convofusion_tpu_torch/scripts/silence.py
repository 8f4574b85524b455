"""Silence detection on raw audio with pydub's semantics.

Port of ``convofusion_tpu/scripts/silence.py:18-98``: ms-indexed analysis
windows with the final window start always analysed, and silent starts
merged into one range unless the gap between them exceeds
``min_silence_len`` (pydub.silence's algorithm), over an O(n) cumulative
energy scan.

The scan runs on ``device``: the squared samples' prefix sum is
``torch.cumsum`` in float64, a sequential sum on the CPU (as numpy's
``cumsum``) and a parallel scan on the card, which adds in another order.
A window's energy is the difference of two prefix sums, so the card's
dBFS differs from the host's by rounding alone: a window within that
rounding of the threshold could fall on the other side of it; any other
decides alike.  The window starts and the merge run on the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from convofusion_tpu_torch import resolve_device


def _window_dbfs(y: np.ndarray, sr: int, starts_ms: np.ndarray,
                 win_ms: int, device=None) -> np.ndarray:
    """RMS dBFS of the ``win_ms`` window at each ms start."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(y)).to(dev, torch.float64)
    sq = torch.cat([x.new_zeros(1), torch.cumsum(x * x, 0)])
    a = (starts_ms * sr // 1000).astype(np.int64)
    b = np.minimum(len(y), ((starts_ms + win_ms) * sr // 1000).astype(
        np.int64))
    n = torch.as_tensor(np.maximum(1, b - a), device=dev)
    a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    rms = torch.sqrt(torch.clamp((sq[b] - sq[a]) / n, min=1e-12))
    return (20.0 * torch.log10(torch.clamp(rms, min=1e-10))).cpu().numpy()


def detect_silence(y: np.ndarray, sr: int = 16000,
                   min_silence_len: int = 1000,
                   silence_thresh: float = -16.0,
                   seek_step: int = 1, device=None) -> List[List[int]]:
    """[[start_ms, end_ms], ...] of silent stretches (pydub's contract):
    window starts every ``seek_step`` ms with the last start
    (seg_len - min_silence_len) always included, and consecutive silent
    starts combined into one range unless the gap between them exceeds
    ``min_silence_len``: two quiet stretches around a short blip are ONE
    range."""
    seg_len = int(len(y) * 1000 / sr)
    if seg_len < min_silence_len:
        return []
    last_slice_start = seg_len - min_silence_len
    starts = np.arange(0, last_slice_start + 1, seek_step)
    if last_slice_start % seek_step:
        starts = np.append(starts, last_slice_start)
    dbfs = _window_dbfs(y, sr, starts, min_silence_len, device)
    silence_starts = starts[dbfs <= silence_thresh]
    if len(silence_starts) == 0:
        return []

    combined: List[List[int]] = []
    prev_i = int(silence_starts[0])
    range_start = prev_i
    for i in silence_starts[1:]:
        i = int(i)
        continuous = i == prev_i + seek_step
        has_gap = i > prev_i + min_silence_len
        if not continuous and has_gap:
            combined.append([range_start, prev_i + min_silence_len])
            range_start = i
        prev_i = i
    combined.append([range_start, prev_i + min_silence_len])
    return combined


def detect_nonsilent(y: np.ndarray, sr: int = 16000,
                     min_silence_len: int = 1000,
                     silence_thresh: float = -16.0,
                     seek_step: int = 1, device=None) -> List[List[int]]:
    """The ranges between :func:`detect_silence`'s, in ms."""
    total_ms = int(len(y) * 1000 / sr)
    silences = detect_silence(y, sr, min_silence_len, silence_thresh,
                              seek_step, device)
    out = []
    cur = 0
    for s, e in silences:
        if s > cur:
            out.append([cur, s])
        cur = max(cur, e)
    if cur < total_ms:
        out.append([cur, total_ms])
    return out


def split_on_silence(y: np.ndarray, sr: int = 16000,
                     min_silence_len: int = 1000,
                     silence_thresh: float = -16.0,
                     keep_silence: int = 100, seek_step: int = 1,
                     device=None):
    """(segments, ranges_ms) with ``keep_silence`` ms of padding at both
    ends of each nonsilent range."""
    total_ms = int(len(y) * 1000 / sr)
    ranges = [
        [max(0, s - keep_silence), min(total_ms, e + keep_silence)]
        for s, e in detect_nonsilent(y, sr, min_silence_len,
                                     silence_thresh, seek_step, device)
    ]
    segs = [y[int(s * sr / 1000):int(e * sr / 1000)] for s, e in ranges]
    return segs, ranges
