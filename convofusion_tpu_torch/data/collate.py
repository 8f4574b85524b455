"""Batch collation to numpy batches.

A copy of ``convofusion_tpu/data/collate.py:1-60`` (reference
convofusion/data/utils.py:27-80, ``beatdnd_collate`` /
``beatdnd_vae_collate``): items sorted by length, longest first, and
zero-padded to the batch maximum.  With MAX_LEN == MIN_LEN == 128 every
motion has one shape; audio lengths differ between sources, so audio is
padded to the batch maximum (the mels are (161, 80) throughout).
"""
from __future__ import annotations

from typing import List

import numpy as np


def _stack_padded(arrs: List[np.ndarray]) -> np.ndarray:
    dims = arrs[0].ndim
    max_size = [max(a.shape[i] for a in arrs) for i in range(dims)]
    out = np.zeros((len(arrs), *max_size), np.float32)
    for i, a in enumerate(arrs):
        out[tuple([i] + [slice(0, s) for s in a.shape])] = a
    return out


def beatdnd_collate(items) -> dict:
    items = [b for b in items if b is not None]
    items.sort(key=lambda x: x[1], reverse=True)
    return {
        "motion_spk": _stack_padded([b[0] for b in items]),
        "length": [b[1] for b in items],
        "motion_lsn": _stack_padded([b[2] for b in items]),
        "melspec_spk": _stack_padded([b[3] for b in items]),
        "melspec_lsn": _stack_padded([b[4] for b in items]),
        "audio_spk": _stack_padded([b[5] for b in items]),
        "audio_lsn": _stack_padded([b[6] for b in items]),
        "text_spk": [b[7] for b in items],
        "text_lsn": [b[8] for b in items],
        "active_passive_lsn": np.stack(
            [b[9] for b in items]).astype(np.int32),
        "name": [b[10] for b in items],
        "spk_name": [b[11] for b in items],
        "lsn_name": [b[12] for b in items],
        "lsn_id": np.asarray([b[13] for b in items], np.int32),
        "other_mlsn": [b[14] for b in items],
        "combined_audio": _stack_padded([b[15] for b in items]),
        "seg_lsn": [b[16] for b in items],
        "seg_spk": [b[17] for b in items],
        "sem_lsn": _stack_padded([b[18] for b in items]),
        "sem_info": [b[19] for b in items],
    }


def beatdnd_vae_collate(items) -> dict:
    items = [b for b in items if b is not None]
    items.sort(key=lambda x: x[1], reverse=True)
    return {
        "motion": _stack_padded([b[0] for b in items]),
        "length": [b[1] for b in items],
        "name": [b[2] for b in items],
    }
