"""The operation and byte counts of ``flops.py`` against counts made by
hand and by PyTorch's FLOP counter over the reference's own products, at
a tiny shape."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops
from perfbench import harness
from perfbench.tests import tiny
from perfbench import weights as W
from perfbench.reference import model as R


@pytest.fixture(scope="module")
def setup():
    cfg = tiny.tiny_model(harness.config("cf_beatdnd")["model"])
    cfg["text_encoder"]["vocab_size"] = 100
    P = W.as_float(W.draw(R.param_specs(cfg, "diffusion"), 3, "cpu"))
    return cfg, R.Ref(P, cfg)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_hand_counts():
    assert flops.mm(2, 3, 4) == 48
    # (7, 2, 16, 8): 6 bf16 planes, the fp32 latents read and written
    n = 2 * 16 * 8
    assert flops.guided_step_bytes(2, 16, 8) == 6 * n * 2 + 2 * n * 4
    assert flops.guided_step_bytes(2, 16, 8, ddpm_noise=True) == \
        6 * n * 2 + 3 * n * 4
    # the production step: 1.17 us at 3.35 TB/s
    assert flops.guided_step_bytes(96, 16, 128) == 3932160


def test_text_audio_counts(setup):
    cfg, ref = setup
    b, L = 3, int(cfg["text_pad_len"])
    ids = torch.randint(0, 100, (b, L))
    valid = torch.ones(b, L, dtype=torch.bool)
    assert counted(lambda: ref.text(ids, valid)) == flops.t5(cfg, b, L)
    mel = torch.randn(b, 161, 80)
    assert counted(lambda: ref.audio(mel)) == flops.audio(cfg, b, 161)


def test_denoiser_counts(setup):
    cfg, ref = setup
    b = 3
    d = int(cfg["denoiser"]["text_encoded_dim"])
    cond = {s: torch.randn(b, n, d)
            for s, n in flops.memory_lengths(cfg).items()}
    lat = torch.randn(b, 16, int(cfg["latent_dim"][1]))
    assert counted(lambda: ref.denoise(lat, 10, cond, {})) == \
        flops.denoiser(cfg, b) + flops.memory_kv(cfg, b)


def test_vae_counts(setup):
    cfg, ref = setup
    b = 2
    d = int(cfg["latent_dim"][1])
    z = torch.randn(2, b, 8, d)
    assert counted(lambda: ref.vae_decode(z, 128)) == flops.vae_decode(cfg, b)
    motion = torch.randn(b, 128, 189)
    assert counted(lambda: ref.vae_encode(motion, torch.zeros(2, b, 8, d))) \
        == flops.vae_encode(cfg, b)
