"""Operations and bytes counted from a configuration's shapes, and the
table of peaks.

A count is the model's algorithmic work, the same whatever implements
it: 2 m k n for each matrix product of the layer equations (attention's
two products included), nothing for elementwise work, norms, softmax or
embedding lookups.  Classifier-free guidance needs six denoiser branches a
step: the full-condition branch has weight 0 in the combine.  A memory's
K/V projection is counted once a step for each distinct memory: the real
conditions' rows, and the one uncond row.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
GUIDED_BRANCHES = 6
VAE_CHUNK = 16


def mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def t5(cfg: Dict, rows: int, length: int) -> float:
    te = cfg["text_encoder"]
    d, dff = int(te["d_model"]), int(te["d_ff"])
    inner = int(te["num_heads"]) * int(te["d_kv"])
    t = rows * length
    layer = (mm(t, d, 3 * inner) + 2 * rows * mm(length, inner, length)
             + mm(t, inner, d) + mm(t, d, dff) + mm(t, dff, d))
    return int(te["num_layers"]) * layer + mm(t, d, int(te["latent_dim"]))


def audio(cfg: Dict, rows: int, frames: int) -> float:
    ae = cfg["audio_encoder"]
    t = rows * frames
    hid, lat = int(ae["hidden_size"]), int(ae["latent_dim"])
    return mm(t, int(ae["input_size"]), hid) + mm(t, hid, lat) + \
        mm(t, lat, lat)


def memory_lengths(cfg: Dict) -> Dict[str, int]:
    """Tokens of each condition stream."""
    return {"spkemb": int(cfg["text_pad_len"]), "alsn": int(cfg["mel_frames"]),
            "tlsn": int(cfg["text_pad_len"]),
            "apb": int(cfg["max_len"]) // VAE_CHUNK, "lsnemb": 1}


def denoiser(cfg: Dict, rows: int) -> float:
    """One pass over ``rows`` latent rows, without the memories' K/V."""
    den = cfg["denoiser"]
    d, ff = int(den["text_encoded_dim"]), int(den["ff_size"])
    ld = int(cfg["latent_dim"][1])
    n = 2 * int(cfg["max_len"]) // VAE_CHUNK
    t = rows * n
    streams = memory_lengths(cfg)
    layer = (mm(t, d, 3 * d) + 2 * rows * mm(n, d, n) + mm(t, d, d)
             + 2 * (mm(rows, d, 2 * d) + mm(t, d, d))
             + sum(mm(t, d, d) * 2 + 2 * rows * mm(n, d, tk)
                   for tk in streams.values())
             + mm(t, len(streams) * d, d) + mm(t, d, ff) + mm(t, ff, d))
    return (int(den["num_layers"]) * layer + mm(t, ld, d) + mm(t, d, ld)
            + 2 * mm(rows, d, d))


def memory_kv(cfg: Dict, rows: int) -> float:
    """Every layer's K/V projection of ``rows`` rows of the five memories."""
    d = int(cfg["denoiser"]["text_encoded_dim"])
    tokens = sum(memory_lengths(cfg).values())
    return int(cfg["denoiser"]["num_layers"]) * mm(rows * tokens, d, 2 * d)


def _vae_layer(cfg: Dict, rows: int, n: int, memory: int) -> float:
    mv = cfg["motion_vae"]
    d, ff = int(cfg["latent_dim"][1]), int(mv["ff_size"])
    t = rows * n
    out = mm(t, d, 3 * d) + 2 * rows * mm(n, d, n) + mm(t, d, d) + \
        mm(t, d, ff) + mm(t, ff, d)
    if memory:
        out += (mm(t, d, d) + mm(rows * memory, d, 2 * d)
                + 2 * rows * mm(n, d, memory) + mm(t, d, d))
    return out


def _skip_stack(cfg: Dict, rows: int, n: int, memory: int) -> float:
    layers = int(cfg["motion_vae"]["num_layers"])
    d = int(cfg["latent_dim"][1])
    return layers * _vae_layer(cfg, rows, n, memory) + \
        (layers - 1) // 2 * mm(rows * n, 2 * d, d)


PARTS = (69, 120)


def vae_decode(cfg: Dict, rows: int) -> float:
    frames, d = int(cfg["max_len"]), int(cfg["latent_dim"][1])
    chunks = frames // VAE_CHUNK
    return sum(_skip_stack(cfg, rows, frames, chunks)
               + mm(rows * frames, d, nf) for nf in PARTS)


def vae_encode(cfg: Dict, rows: int) -> float:
    frames, d = int(cfg["max_len"]), int(cfg["latent_dim"][1])
    n = rows * frames // VAE_CHUNK
    tokens = 2 * int(cfg["latent_dim"][0]) + VAE_CHUNK
    return sum(_skip_stack(cfg, n, tokens, 0)
               + mm(rows * frames, nf, d) for nf in PARTS)


def sample_call(cfg: Dict, rows: int) -> float:
    """A guided sampling call: the conditions of both texts and the mel,
    every reverse step's six branches and memory K/V, the decode."""
    steps = int(cfg["scheduler"]["num_inference_timesteps"])
    encode = 2 * t5(cfg, rows, int(cfg["text_pad_len"])) + \
        audio(cfg, rows, int(cfg["mel_frames"]))
    step = denoiser(cfg, GUIDED_BRANCHES * rows) + memory_kv(cfg, rows + 1)
    return encode + steps * step + vae_decode(cfg, rows)


def train_step(cfg: Dict, stage: str, rows: int) -> float:
    """A training step: frozen forwards once, the trainable forward three
    times (forward and backward)."""
    if stage == "vae":
        return 3 * (vae_encode(cfg, rows) + vae_decode(cfg, rows))
    te = cfg["text_encoder"]
    length = int(cfg["text_pad_len"])
    proj = mm(rows * length, int(te["d_model"]), int(te["latent_dim"]))
    frozen = 2 * (t5(cfg, rows, length) - proj) + vae_encode(cfg, rows)
    trained = (2 * proj + audio(cfg, rows, int(cfg["mel_frames"]))
               + denoiser(cfg, rows) + memory_kv(cfg, rows))
    return frozen + 3 * trained


def guided_step_bytes(rows: int, tokens: int, width: int,
                      plane_bytes: int = 2, ddpm_noise: bool = False) -> int:
    """The fused guidance + DDIM/DDPM update's least traffic: planes 0-5
    read once, the fp32 latents read, the fp32 output written, the fp32
    noise read on a DDPM step."""
    n = rows * tokens * width
    return 6 * n * plane_bytes + 4 * n * (2 + int(ddpm_noise))
