"""Mel-frame encoder and the text/audio controller.

``AudioConvEncoder`` (``convofusion_tpu/models/audioenc.py:20-36``): an MLP
Linear 80->256 -> Dropout -> LeakyReLU(0.1) -> Linear 256->512 -> Dropout
-> LeakyReLU(0.1) -> Linear out.  Names follow the reference ``main``
Sequential; the dropout rate is the JAX module's default, 0.1, which
``models/factory.py:164-175`` never overrides.

``TextAudioController`` (JAX :39-102): the audio encoder plus, in the
'spk-ta' mode, a fused control signal from the text and the audio
projected along time.  No pipeline builds it (the reference's production
path never reaches the spk-ta branch); it is ported as a module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from convofusion_tpu_torch.ops.layers import Dropout, Linear


class AudioConvEncoder(nn.Module):
    def __init__(self, input_size: int = 80, hidden_size: int = 256,
                 latent_dim: int = 512, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.main = nn.Sequential(
            Linear(input_size, hidden_size, dtype=dtype), Dropout(dropout),
            nn.LeakyReLU(0.1),
            Linear(hidden_size, latent_dim, dtype=dtype), Dropout(dropout),
            nn.LeakyReLU(0.1))
        self.out_net = Linear(latent_dim, latent_dim, dtype=dtype)

    def forward(self, x):
        """x (B, T_mel, n_mels) -> (B, T_mel, latent_dim)."""
        return self.out_net(self.main(x))


class TextAudioController(nn.Module):
    """The text and audio embeddings with their masks, and in the 'spk-ta'
    mode a fused (B, out_dim, D) control signal.  The text is encoded
    outside (the shared T5), so the module takes its embedding and
    mask."""

    def __init__(self, out_dim: int = 512, text_max_length: int = 200,
                 audio_max_length: int = 161, audio_input_size: int = 80,
                 audio_hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_max_length = text_max_length
        self.audio_encoder = AudioConvEncoder(
            audio_input_size, audio_hidden_size, out_dim, dtype=dtype)
        # projections along the time axis: text_max_length / mel frames ->
        # out_dim tokens
        self.text_time_proj = Linear(text_max_length, out_dim, dtype=dtype)
        self.audio_time_proj = Linear(audio_max_length, out_dim, dtype=dtype)
        self.out_net = Linear(out_dim, out_dim, dtype=dtype)

    def forward(self, text_emb, text_mask, audio, person_type: str):
        """text_emb (B, Tt, D); text_mask (B, Tt) bool, True = valid;
        audio (B, Ta, n_mels) mel frames.  Returns (audio_emb, text_emb,
        None, pad_mask (True = pad), fused or None unless 'spk-ta')."""
        pad_mask = ~text_mask
        audio_emb = self.audio_encoder(audio)
        if person_type != "spk-ta":
            return audio_emb, text_emb, None, pad_mask, None
        # the reference multiplies by the INVERTED mask, keeping the pad
        # positions and zeroing the words (audioenc.py:70-89); JAX keeps the
        # quirk, and so does the port
        tm = (text_emb * pad_mask.to(text_emb.dtype)[..., None]
              ).transpose(1, 2)                       # (B, D, Tt)
        tm = F.pad(tm, (0, self.text_max_length - tm.shape[-1]))
        text_ctrl = F.leaky_relu(self.text_time_proj(tm), 0.01
                                 ).transpose(1, 2)
        audio_ctrl = F.leaky_relu(self.audio_time_proj(
            audio_emb.transpose(1, 2)), 0.01).transpose(1, 2)
        fused = self.out_net(text_ctrl + audio_ctrl)
        return audio_emb, text_emb, None, pad_mask, fused
