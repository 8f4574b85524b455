"""Mask helpers (``convofusion_tpu/utils/masks.py``; reference
temos_utils.py:11-29)."""
from __future__ import annotations

import numpy as np
import torch


def lengths_to_mask(lengths, max_len: int) -> torch.Tensor:
    """(bs,) int lengths -> (bs, max_len) bool mask, True = valid frame, on
    the lengths' device."""
    lengths = torch.as_tensor(lengths)
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def remove_padding(tensors, lengths):
    """Host side: trim a batch of arrays to their true lengths (a list)."""
    return [np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)[
        : int(l)] for t, l in zip(tensors, lengths)]
