"""The port against the JAX package at the production geometry
(``config_cf_beatdnd.yaml``: T5-base, the 9-layer 512-wide denoiser, the
5-layer VAE at latent [1, 128]), fp32 on the CPU, on the same weights: the
port's seeded weights carried into a JAX tree by the JAX converters
(``test_torch_train.jax_params_from_port``), with the config's 32k vocab
and a word-hash tokenizer over 64 tokens, so no asset is needed.

Every other parity test runs the tiny geometry.  The bounds come from a
one-off measurement at this geometry (JAX ``init_params`` weights): T5 and
its projection over full 64-token rows 2.35e-4 (both fp32 sides ~2e-4
from an fp64 run: rounding), ``sample()`` at batch 2, DDIM-4 with JAX's
noise replayed, 3.9e-4 in the latents and 4.4e-5 in the motion, VAE
decode 2.9e-6.  Each bound leaves about 4-7x headroom over its gap.

``slow``: the JAX side's compiles at this width take minutes on the CPU,
so tier-1 (``-m 'not slow'``) skips it.
"""
import os

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu import config as jax_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.tokenizer import WordHashTokenizer as JaxWordHash
from convofusion_tpu_torch.config import DEFAULTS_DIR, from_cfg, load_config
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.tokenizer import WordHashTokenizer
from test_torch_sampler import _jax_noise_sequence
from test_torch_train import jax_params_from_port

pytestmark = pytest.mark.slow

PAD, B, STEPS = 64, 2, 4
T5_ATOL = 1e-3          # 2.35e-4 measured: 4.3x
LATENT_ATOL = 2e-3      # 3.9e-4: 5.1x
MOTION_ATOL = 2.5e-4    # 4.4e-5: 5.7x
DECODE_ATOL = 2e-5      # 2.9e-6: 6.9x
OVERRIDES = ["model.scheduler.variant=ddim",
             f"model.scheduler.num_inference_timesteps={STEPS}",
             f"TPU.TEXT_PAD_LEN={PAD}"]


@pytest.fixture(scope="module")
def twins():
    name = "config_cf_beatdnd.yaml"
    jcfg = jax_config.load_config(
        os.path.join(jax_config.DEFAULTS_DIR, name), overrides=OVERRIDES)
    jm = JaxConvofusion(jcfg)
    jm.tokenizer = JaxWordHash(vocab_size=32128, max_length=PAD)
    cfg = from_cfg(load_config(os.path.join(DEFAULTS_DIR, name),
                               overrides=OVERRIDES))
    pm = Convofusion(cfg, device="cpu", seed=0,
                     tokenizer=WordHashTokenizer(vocab_size=32128,
                                                 max_length=PAD))
    params = jax_params_from_port(pm)
    raw = jax_synthetic.synthetic_raw_batch(7, B, mel_frames=cfg["mel_frames"])
    # full 64-token rows: every relative-position bucket in use
    words = " ".join(f"w{i}" for i in range(2 * PAD))
    raw["text_spk"] = [words] * B
    raw["text_lsn"] = [words[::-1]] * B
    return jm, params, pm, raw


def test_t5_stack_and_projection(twins):
    jm, params, pm, raw = twins
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    assert jb["spk_tmask"].all()
    want = np.asarray(jax.jit(jm.encode_text)(
        params, jb["spk_ids"], jb["spk_tmask"]))
    with torch.no_grad():
        got = pm.encode_text(tb["spk_ids"], tb["spk_tmask"]).numpy()
    assert got.shape == (B, PAD, 512)
    assert np.abs(got - want).max() <= T5_ATOL


def test_guided_sample_and_decode(twins):
    jm, params, pm, raw = twins
    jb, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tb, _, _ = torch_synthetic.prepare_arrays(pm, raw)
    key = jax.random.PRNGKey(8)
    motion_j, lat_j, _ = jax.jit(
        lambda p, b, k: jm.sample(p, b, k, num_inference_steps=STEPS))(
            params, jb, key)
    init, steps = _jax_noise_sequence(key, STEPS, (B, 16, 128))
    motion_p, lat_p = pm.sample(tb, num_inference_steps=STEPS,
                                init_noise=torch.from_numpy(init),
                                step_noise=torch.from_numpy(steps))
    assert np.abs(lat_p.numpy() - np.asarray(lat_j)).max() <= LATENT_ATOL
    assert np.abs(motion_p.numpy() - np.asarray(motion_j)).max() <= \
        MOTION_ATOL
    # VAE decode alone, on JAX's latents: (B, 16, D) -> (2, B, 8, D)
    z = np.asarray(lat_j).reshape(B, 8, 2, 128).transpose(2, 0, 1, 3).copy()
    want = np.asarray(jax.jit(jm.vae_decode)(params, z))
    with torch.no_grad():
        got = pm.vae.decode(torch.from_numpy(z), 128).numpy()
    assert got.shape == want.shape == (B, 128, 189)
    assert np.abs(got - want).max() <= DECODE_ATOL
