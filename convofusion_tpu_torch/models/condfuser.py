"""Condition fuser (``convofusion_tpu/models/condfuser.py:20-41``):
assembles the five-stream condition dict, embedding the per-chunk
active/passive bit (vocab 3: 0/1/2-uncond) and the listener id (vocab 36
= 5 DnD + 1 uncond + 30 BEAT speakers)."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


NUM_APB_CLASSES = 3
NUM_LISTENER_IDS = 5 + 1 + 30


class TextAudioMotionFuser(nn.Module):
    def __init__(self, out_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.active_passive_emb = nn.Embedding(NUM_APB_CLASSES, out_dim,
                                            dtype=dtype)
        self.lsn_id_emb = nn.Embedding(NUM_LISTENER_IDS, out_dim, dtype=dtype)

    def forward(self, spkemb, alsn, tlsn, active_passive_bit, lsn_id
                ) -> Dict[str, torch.Tensor]:
        """spkemb (B, Ts, D); alsn (B, Ta, D); tlsn (B, Tt, D);
        active_passive_bit (B, n_chunks) int; lsn_id (B,) int."""
        return {
            "spkemb": spkemb,
            "alsn": alsn,
            "tlsn": tlsn,
            "apb": self.active_passive_emb(active_passive_bit.long()),
            "lsnemb": self.lsn_id_emb(lsn_id.long())[:, None, :],
        }
