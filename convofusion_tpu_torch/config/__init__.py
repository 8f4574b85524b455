"""Model geometries as plain dicts (no YAML parser needed).

``PRODUCTION`` is the stage-2 model of
``convofusion_tpu/config/defaults/config_cf_beatdnd.yaml`` with its module
files ``modules/{denoiser,motion_vae,text_encoder,audio_encoder,
scheduler}.yaml``; ``PRODUCTION_VAE`` the same model under the stage-1
experiment ``config_vae_beatdnd.yaml``.  ``TINY`` and ``TINY_VAE`` are the
small geometry of ``convofusion_tpu/config/testing.py:10-36``
(``tiny_config('diffusion')`` and ``tiny_config('vae')``), with WEG off.
Sub-dicts are the constructor arguments of the port's modules;
``weg_parameters``, ``serve`` and ``fps`` are read by the sampler, the
service and the long-form rollout, ``train`` by the training losses and
the trainer.

The YAML side is a copy of ``convofusion_tpu/config/__init__.py:44-138``
(``ablation_flag``, ``get_module_config``, ``load_config``, ``parse_args``)
over copies of its ``defaults/**.yaml`` files and of ``config/omega.py``;
``from_cfg`` maps a merged config onto the dicts above and ``tiny_config``
is ``convofusion_tpu/config/testing.py:10-36`` (``config/from_yaml.py``).
"""
from __future__ import annotations

import copy
import os
from argparse import ArgumentParser

from convofusion_tpu_torch.config.omega import DictConfig, OmegaConf

# the BEAT/DnD skeleton's (parent, child) bones: assets.yaml:12
BONES = (
    (0, 4), (4, 3), (3, 2), (2, 1), (0, 18), (18, 19), (19, 20), (20, 21),
    (21, 22), (0, 13), (13, 14), (14, 15), (15, 16), (16, 17), (3, 9),
    (9, 10), (10, 11), (3, 5), (5, 6), (6, 7), (7, 23), (23, 24), (24, 25),
    (25, 26), (7, 27), (27, 28), (28, 29), (29, 30), (7, 8), (8, 31),
    (31, 32), (32, 33), (33, 34), (7, 35), (35, 36), (36, 37), (37, 38),
    (7, 39), (39, 40), (40, 41), (41, 42), (11, 43), (43, 44), (44, 45),
    (45, 46), (11, 47), (47, 48), (48, 49), (49, 50), (11, 12), (12, 51),
    (51, 52), (52, 53), (53, 54), (11, 55), (55, 56), (56, 57), (57, 58),
    (11, 59), (59, 60), (60, 61), (61, 62),
)

# TRAIN.OPTIM beyond TYPE and LR, at the defaults
# convofusion_tpu/train/trainer.py:53-72 reads them with (torch AdamW's
# weight decay; a constant schedule; no gradient clipping)
_OPTIM_DEFAULTS = {
    "type": "adamw",
    "weight_decay": 1e-2,
    "schedule": "constant",       # or 'cosine'
    "warmup_steps": 0,
    "decay_steps": 10_000,
    "end_lr_factor": 0.0,
    "grad_clip": 0.0,             # global-norm clip; 0 = off
}

# stage 2: config_cf_beatdnd.yaml (LAMBDA_BL absent there: base.yaml:75)
TRAIN_DIFFUSION = {
    "batch_size": 64,                                  # :11
    "optim": {**_OPTIM_DEFAULTS, "lr": 7e-5},          # :15-17
    "loss": {                                          # :54-63
        "lambda_latent": 0.0,
        "lambda_kl": 5.0e-2,
        "lambda_rec": 5.0,
        "lambda_prior": 0.0,
        "lambda_guided_attention": 0.0,
        "lambda_bl": 0.0,
    },
    "laplace_kernel_size": 5,     # modules/motion_vae.yaml:14
    "bones": BONES,
}

# stage 1: config_vae_beatdnd.yaml
TRAIN_VAE = {
    "batch_size": 128,                                 # :17
    "optim": {**_OPTIM_DEFAULTS, "lr": 1e-4},          # :22
    "loss": {                                          # :44-53
        "lambda_latent": 1.0e-4,
        "lambda_kl": 5.0e-2,
        "lambda_rec": 5.0,
        "lambda_prior": 0.0,
        "lambda_guided_attention": 0.0,   # base.yaml:76
        "lambda_bl": 1.0,
    },
    "laplace_kernel_size": 5,
    "bones": BONES,
}

PRODUCTION = {
    "latent_dim": [1, 128],        # config_cf_beatdnd.yaml:70
    "nfeats": 189,                 # DATASET.NFEATS (BEAT/DnD joints x 3)
    "max_len": 128,                # config_cf_beatdnd.yaml:46 (SAMPLER.MAX_LEN)
    "text_pad_len": 64,            # base.yaml:124 (TPU.TEXT_PAD_LEN)
    "mel_frames": 161,             # audioenc.audio_num_frames(128, 25, 16000, 512)
    "guidance_scale": 7.5,         # config_cf_beatdnd.yaml:76
    "guidance_uncondp": 0.1,       # config_cf_beatdnd.yaml:77
    "fps": 25,                     # DATASET.BEATDND.FPS (base.yaml:101)
    "predict_epsilon": True,       # config_cf_beatdnd.yaml:23
    # TRAIN.ABLATION.VAE_TYPE (base.yaml:25); 'no' diffuses raw motion
    "vae_type": "convofusion",
    # the tokenizer's model (modules/text_encoder.yaml:5, assets.yaml:16):
    # a spiece.model is looked up for it (models/tokenizer.find_spiece)
    "t5_path": "t5-base",
    # TPU.PALLAS_STEP (default true, convofusion_tpu/models/convofusion.py:
    # 175-177): guided DDIM/DDPM steps through the fused step kernel; false
    # takes the plain combine and update
    "pallas_step": True,
    # TPU.SCAN_UNROLL (default 1, :181-182): recorded only
    "scan_unroll": 1,
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
        "dropout": 0.1,
        "fuse_streams": False,     # the five cross-attentions as one
        "remat": False,            # TPU.REMAT: recompute layers in backward
        "arch": "trans_dec",       # or trans_enc, the concat ablation
        "condition": "text+audio",  # config_cf_beatdnd.yaml:69
    },
    "motion_vae": {                # modules/motion_vae.yaml
        "arch": "encoder_decoder",
        "ff_size": 1024,
        "num_layers": 5,
        "num_heads": 2,
        "normalize_before": True,
        "activation": "gelu",
        "position_embedding": "sine",
        "dropout": 0.1,
        "mlp_dist": False,         # TRAIN.ABLATION.MLP_DIST (base.yaml:30)
    },
    "text_encoder": {              # modules/text_encoder.yaml + t5-base dims
        "latent_dim": 512,         # (models/factory.py:141-161)
        "vocab_size": 32128,
        "d_model": 768,
        "d_ff": 3072,
        "num_layers": 12,
        "num_heads": 12,
        "d_kv": 64,
        "dropout": 0.0,            # the trunk's, in the stage-2 loss
    },
    "audio_encoder": {             # modules/audio_encoder.yaml
        "input_size": 80,
        "hidden_size": 256,
        "latent_dim": 512,
        "dropout": 0.1,            # the module's default (audioenc.py:24)
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
    # modules/scheduler.yaml:13-21: the training scheduler, DDPM; the
    # long-form rollout re-noises the previous window's latents with its
    # add_noise (convofusion_tpu/models/convofusion.py:170-171,676,760)
    "noise_scheduler": {
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
    "train": copy.deepcopy(TRAIN_DIFFUSION),
}


def _with_train(cfg, train):
    out = copy.deepcopy(cfg)
    out["train"] = copy.deepcopy(train)
    return out


PRODUCTION_VAE = _with_train(PRODUCTION, TRAIN_VAE)


def _tiny():
    cfg = copy.deepcopy(PRODUCTION)
    cfg["latent_dim"] = [1, 32]
    cfg["text_pad_len"] = 16
    # dropout 0 in the VAE and the denoiser; the audio MLP keeps its 0.1
    cfg["denoiser"].update(num_layers=3, ff_size=64, text_encoded_dim=64,
                           dropout=0.0)
    cfg["motion_vae"].update(num_layers=3, ff_size=64, dropout=0.0)
    cfg["text_encoder"].update(latent_dim=64, d_model=32, d_ff=64,
                               num_layers=2, num_heads=4, d_kv=8,
                               vocab_size=1000)
    cfg["audio_encoder"].update(latent_dim=64)
    # testing.py leaves modules/scheduler.yaml as it is: DDPM, 1000 steps
    cfg["scheduler"].update(variant="ddpm", num_inference_timesteps=1000)
    cfg["weg_type"] = "no"         # base.yaml:34
    return cfg


TINY = _tiny()
TINY_VAE = _with_train(TINY, TRAIN_VAE)


# ------------------------------------------------------------- YAML configs
DEFAULTS_DIR = os.path.join(os.path.dirname(__file__), "defaults")


def ablation_flag(cfg, key: str, default: str = "no") -> str:
    """Read a TRAIN.ABLATION string flag, normalizing the YAML-1.1 footgun.

    The flags' most natural spelling is the bare word ``no``, which YAML 1.1
    parses as boolean False; ``str(False)`` is ``"False"``, which silently
    flips `== "no"` gates the wrong way.  Map False back to ``"no"`` (and
    True to ``"yes"``) before stringifying
    (convofusion_tpu/config/__init__.py:44-60)."""
    try:
        v = cfg.TRAIN.ABLATION.get(key, default)
    except (KeyError, AttributeError):
        v = default
    if v is False:
        return "no"
    if v is True:
        return "yes"
    return str(v)


def get_module_config(cfg_model, modules_dir: str) -> DictConfig:
    """Merge every ``modules/*.yaml`` into ``cfg_model``, in name order."""
    for fname in sorted(os.listdir(modules_dir)):
        if fname.endswith(".yaml"):
            cfg_model.merge_with(
                OmegaConf.load(os.path.join(modules_dir, fname)))
    return cfg_model


def load_config(
    cfg_path: str,
    assets_path: str | None = None,
    modules_dir: str | None = None,
    base_path: str | None = None,
    overrides: list[str] | None = None,
    phase: str = "train",
) -> DictConfig:
    """The 4-way merge base.yaml <- experiment yaml <- modules/*.yaml <-
    assets.yaml, then dotlist ``overrides``
    (convofusion_tpu/config/__init__.py:88-114)."""
    base_path = base_path or os.path.join(DEFAULTS_DIR, "base.yaml")
    assets_path = assets_path or os.path.join(DEFAULTS_DIR, "assets.yaml")
    modules_dir = modules_dir or os.path.join(DEFAULTS_DIR, "modules")

    cfg_exp = OmegaConf.merge(
        OmegaConf.load(base_path), OmegaConf.load(cfg_path))
    cfg_model = get_module_config(cfg_exp.model, modules_dir)
    cfg = OmegaConf.merge(cfg_exp, cfg_model, OmegaConf.load(assets_path))
    if overrides:
        cfg = OmegaConf.merge(cfg, OmegaConf.from_dotlist(overrides))

    if phase == "test":
        cfg.DEBUG = False
        cfg.DEVICE = [0]
    if cfg.get("DEBUG"):
        cfg.NAME = "debug--" + str(cfg.NAME)
        cfg.LOGGER.VAL_EVERY_STEPS = 1
    return cfg


def parse_args(phase: str = "train", argv=None) -> DictConfig:
    """``--cfg``, ``--cfg_assets``, ``--batch_size``, ``--nodebug``,
    ``--dir`` and dotlist overrides (convofusion_tpu/config/__init__.py:
    117-138)."""
    parser = ArgumentParser()
    parser.add_argument("--cfg", type=str,
                        default=os.path.join(DEFAULTS_DIR,
                                             "config_cf_beatdnd.yaml"))
    parser.add_argument("--cfg_assets", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--nodebug", action="store_true")
    parser.add_argument("--dir", type=str, default=None)
    parser.add_argument("overrides", nargs="*",
                        help="dotlist overrides key=value")
    params = parser.parse_args(argv)

    cfg = load_config(params.cfg, params.cfg_assets,
                      overrides=params.overrides, phase=phase)
    if params.batch_size:
        cfg.TRAIN.BATCH_SIZE = params.batch_size
    if params.nodebug:
        cfg.DEBUG = False
    if params.dir:
        cfg.TEST.TEST_DIR = params.dir
    return cfg


# the merged config -> the dicts above (imports the names defined here)
from convofusion_tpu_torch.config.from_yaml import (  # noqa: E402
    from_cfg,
    tiny_config,
)
