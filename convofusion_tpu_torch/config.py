"""Model geometries as plain dicts (no YAML parser needed).

``PRODUCTION`` is the stage-2 model of
``convofusion_tpu/config/defaults/config_cf_beatdnd.yaml`` with its module
files ``modules/{denoiser,motion_vae,text_encoder,audio_encoder,
scheduler}.yaml``; ``TINY`` is the small geometry of
``convofusion_tpu/config/testing.py:10-36`` (``tiny_config('diffusion')``),
with WEG off.  Sub-dicts are the constructor arguments of the port's
modules; ``weg_parameters`` and ``serve`` are read by the sampler and the
service.
"""
from __future__ import annotations

import copy

PRODUCTION = {
    "latent_dim": [1, 128],        # config_cf_beatdnd.yaml:70
    "nfeats": 189,                 # DATASET.NFEATS (BEAT/DnD joints x 3)
    "max_len": 128,                # config_cf_beatdnd.yaml:46 (SAMPLER.MAX_LEN)
    "text_pad_len": 64,            # base.yaml:124 (TPU.TEXT_PAD_LEN)
    "mel_frames": 161,             # audioenc.audio_num_frames(128, 25, 16000, 512)
    "guidance_scale": 7.5,         # config_cf_beatdnd.yaml:76
    "predict_epsilon": True,       # config_cf_beatdnd.yaml:23
    "denoiser": {                  # modules/denoiser.yaml
        "text_encoded_dim": 512,
        "ff_size": 1024,
        "num_layers": 9,
        "num_heads": 4,
        "normalize_before": True,
        "activation": "gelu",
        "flip_sin_to_cos": True,
        "freq_shift": 0.0,
        "position_embedding": "sine",
    },
    "motion_vae": {                # modules/motion_vae.yaml
        "arch": "encoder_decoder",
        "ff_size": 1024,
        "num_layers": 5,
        "num_heads": 2,
        "normalize_before": True,
        "activation": "gelu",
        "position_embedding": "sine",
    },
    "text_encoder": {              # modules/text_encoder.yaml + t5-base dims
        "latent_dim": 512,         # (models/factory.py:141-161)
        "vocab_size": 32128,
        "d_model": 768,
        "d_ff": 3072,
        "num_layers": 12,
        "num_heads": 12,
        "d_kv": 64,
    },
    "audio_encoder": {             # modules/audio_encoder.yaml
        "input_size": 80,
        "hidden_size": 256,
        "latent_dim": 512,
    },
    # modules/scheduler.yaml:1-11 (scaled_linear 0.00085 -> 0.012,
    # fixed_small, clip_sample, eta 0); DDIM at 50 steps is the sampling
    # setting bench.py times (bench.py:27,90)
    "scheduler": {
        "variant": "ddim",
        "eta": 0.0,
        "num_inference_timesteps": 50,
        "num_train_timesteps": 1000,
        "beta_start": 0.00085,
        "beta_end": 0.012,
        "beta_schedule": "scaled_linear",
        "clip_sample": True,
    },
    # word-excitation guidance: TRAIN.ABLATION.WEG_TYPE
    # (config_cf_beatdnd.yaml:19); any value but 'no' runs it
    "weg_type": "semantic",
    "weg_parameters": {            # assets.yaml:17-22
        "scale_factor": 1000,
        "scale_range": [1.0, 0.5],
        "max_iter_to_alter": 800,
        # reverse-step index -> refinement threshold
        "thresholds": {0: 0.05, 200: 0.4, 400: 0.6, 600: 0.8},
        "max_refinement_steps": 300,
    },
    # the service's knobs as convofusion_tpu/serving.py:520-532 resolves
    # them with no SERVE block; its steps are the scheduler's
    # num_inference_timesteps (:526-527)
    "serve": {
        "batch_size": 32,          # TEST.BATCH_SIZE (config_cf_beatdnd.yaml:36)
        "max_wait_ms": 25.0,       # serving.py:525
        "max_queue": None,         # serving.py:530-531: 8 x batch_size
        "seed": 1234,              # SEED_VALUE (base.yaml:3), serving.py:529
        "weg_max_focus": 8,        # serving.py:121
        "host": "127.0.0.1",       # serving.py:549
        "port": 8476,              # serving.py:550
    },
}


def _tiny():
    cfg = copy.deepcopy(PRODUCTION)
    cfg["latent_dim"] = [1, 32]
    cfg["text_pad_len"] = 16
    cfg["denoiser"].update(num_layers=3, ff_size=64, text_encoded_dim=64)
    cfg["motion_vae"].update(num_layers=3, ff_size=64)
    cfg["text_encoder"].update(latent_dim=64, d_model=32, d_ff=64,
                               num_layers=2, num_heads=4, d_kv=8,
                               vocab_size=1000)
    cfg["audio_encoder"].update(latent_dim=64)
    # testing.py leaves modules/scheduler.yaml as it is: DDPM, 1000 steps
    cfg["scheduler"].update(variant="ddpm", num_inference_timesteps=1000)
    cfg["weg_type"] = "no"         # base.yaml:34
    return cfg


TINY = _tiny()
