"""A merged YAML config mapped onto the port's config dict, and the tiny
test config.

``from_cfg`` reads every key the JAX model reads
(``convofusion_tpu/models/convofusion.py:60-183``, ``models/factory.py:
46-179``, ``train/trainer.py:43-77``, ``serving.py:469-532``) and returns a
dict shaped like ``config.PRODUCTION``.  A knob the port does not implement,
or one where JAX raises, raises ``NotImplementedError`` (a value JAX
rejects, ``ValueError``) naming its key; none is ignored.  Keys the
JAX model never reads (``TRAIN.ABLATION.PE_TYPE``, ``LOSS.LAMBDA_CROSS``,
the dataset roots, ...) are not read here either.

``tiny_config`` is ``convofusion_tpu/config/testing.py:10-36`` over the
port's loader.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from convofusion_tpu_torch.config import (
    DEFAULTS_DIR,
    _OPTIM_DEFAULTS,
    ablation_flag,
    load_config,
)


def _unsupported(key: str, value, why: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"{key}={value!r} is not supported{': ' + why if why else ''}")


def _params(block) -> Dict:
    """A module block's ``params`` as a plain dict (interpolations
    resolved)."""
    params = block.get("params", {}) if block is not None else {}
    return params.to_container() if hasattr(params, "to_container") \
        else dict(params)


# the values JAX builds (models/vae.py:71-86, models/denoiser.py:59-60,
# ops/positional.py:75-84); any other raises ValueError there and here
VAE_ARCHS = ("encoder_decoder", "all_encoder")
DENOISER_ARCHS = ("trans_dec", "trans_enc")
POSITION_EMBEDDINGS = ("sine", "v2", "sine_bh", "learned", "v3")


def _check_transformer(name: str, params: Dict, archs) -> None:
    """The VAE's or the denoiser's ``arch`` and ``position_embedding``
    (values JAX builds), and no ``compute_dtype``."""
    for key, allowed, default in (("arch", archs, archs[0]),
                                  ("position_embedding",
                                   POSITION_EMBEDDINGS, "sine")):
        value = str(params.get(key, default))
        if value not in allowed:
            raise ValueError(f"model.{name}.params.{key}={value!r}: not one "
                             f"of {allowed}")
    if "compute_dtype" in params:
        raise _unsupported(f"model.{name}.params.compute_dtype",
                           params["compute_dtype"],
                           "pass dtype= to the port's entry point")


def _transformer(params: Dict, keys) -> Dict:
    return {k: params[k] for k in keys}


def _scheduler(block, predict_epsilon: bool, key: str,
               with_inference: bool) -> Dict:
    """A scheduler block: ``variant`` from the block or its params (JAX
    :156-167), ``variance_type`` fixed_small only (factory.py:176-179)."""
    params = _params(block)
    vt = params.pop("variance_type", "fixed_small")
    if vt != "fixed_small":
        raise _unsupported(f"model.{key}.params.variance_type", vt)
    pt = params.pop("prediction_type", None)
    if pt is not None and pt != ("epsilon" if predict_epsilon else "sample"):
        raise _unsupported(f"model.{key}.params.prediction_type", pt,
                           "it follows TRAIN.ABLATION.PREDICT_EPSILON")
    variant = block.get("variant", params.pop("variant", "ddpm"))
    unknown = set(params) - {"num_train_timesteps", "beta_start", "beta_end",
                             "beta_schedule", "clip_sample"}
    if unknown:
        raise _unsupported(f"model.{key}.params", sorted(unknown))
    out = {
        "num_train_timesteps": int(params.get("num_train_timesteps", 1000)),
        "beta_start": float(params.get("beta_start", 0.00085)),
        "beta_end": float(params.get("beta_end", 0.012)),
        "beta_schedule": str(params.get("beta_schedule", "scaled_linear")),
        "clip_sample": bool(params.get("clip_sample", True)),
    }
    if with_inference:
        out = {"variant": str(variant), "eta": float(block.get("eta", 0.0)),
               "num_inference_timesteps": int(
                   block.get("num_inference_timesteps", 1000)), **out}
    elif str(variant) != "ddpm":
        raise _unsupported(f"model.{key}.variant", variant,
                           "the training scheduler is DDPM")
    return out


def _tpu(cfg) -> Dict:
    """The ``TPU`` block's knobs beyond TEXT_PAD_LEN and REMAT
    (convofusion.py:149-182): PALLAS_STEP and SCAN_UNROLL are read;
    MESH.MODEL > 1 (tensor parallelism) raises."""
    tpu = cfg.get("TPU", {})
    mesh = tpu.get("MESH", {})
    if int(mesh.get("MODEL", 1)) != 1:
        raise _unsupported("TPU.MESH.MODEL", mesh.get("MODEL"),
                           "tensor parallelism is not ported")
    return {"pallas_step": bool(tpu.get("PALLAS_STEP", True)),
            "scan_unroll": int(tpu.get("SCAN_UNROLL", 1))}


def _train(cfg, vae_params: Dict, ds) -> Dict:
    """``train``: TRAIN.BATCH_SIZE, TRAIN.OPTIM (trainer.py:43-77), the LOSS
    weights (convofusion.py:302-304,524-527), the Laplace filter size and
    the dataset's bones."""
    optim = cfg.TRAIN.OPTIM
    loss = cfg.LOSS
    try:
        bones = tuple(tuple(int(j) for j in b) for b in ds.BONES)
    except (KeyError, AttributeError):
        bones = None
    return {
        "batch_size": int(cfg.TRAIN.BATCH_SIZE),
        "optim": {
            "type": str(optim.TYPE).lower(),
            "weight_decay": float(optim.get(
                "WEIGHT_DECAY", _OPTIM_DEFAULTS["weight_decay"])),
            "schedule": str(optim.get("SCHEDULE", "constant")).lower(),
            "warmup_steps": int(optim.get("WARMUP_STEPS", 0)),
            "decay_steps": int(optim.get("DECAY_STEPS", 10_000)),
            "end_lr_factor": float(optim.get("END_LR_FACTOR", 0.0)),
            "grad_clip": float(optim.get("GRAD_CLIP", 0.0)),
            "lr": float(optim.LR),
        },
        "loss": {
            "lambda_latent": float(loss.LAMBDA_LATENT),
            "lambda_kl": float(loss.LAMBDA_KL),
            "lambda_rec": float(loss.LAMBDA_REC),
            "lambda_prior": float(loss.get("LAMBDA_PRIOR", 0.0)),
            "lambda_guided_attention": float(
                loss.get("LAMBDA_GUIDED_ATTENTION", 0.0)),
            "lambda_bl": float(loss.get("LAMBDA_BL", 0.0)),
        },
        "laplace_kernel_size": int(vae_params.get("laplace_kernel_size", 0)),
        "bones": bones,
    }


def _serve(cfg) -> Dict:
    """The service's knobs as ``_serve_opt`` resolves them
    (convofusion_tpu/serving.py:469-532)."""
    serve = cfg.get("SERVE", {})

    def opt(key, default):
        return serve.get(key, default) if hasattr(serve, "get") else default

    max_queue = int(opt("MAX_QUEUE", -1))
    return {
        "batch_size": int(opt("BATCH_SIZE", cfg.TEST.get("BATCH_SIZE", 8))),
        "max_wait_ms": float(opt("MAX_WAIT_MS", 25.0)),
        "max_queue": max_queue if max_queue >= 0 else None,
        "seed": int(cfg.get("SEED_VALUE", 0)),
        "weg_max_focus": 8,                 # serving.py:121, no config key
        "host": str(opt("HOST", "127.0.0.1")),
        "port": int(opt("PORT", 8476)),
    }


def _vae_type(model, cfg) -> str:
    """The VAE type as JAX resolves it (convofusion.py:84-110):
    ``model.vae_type``, then ``TRAIN.ABLATION.VAE_TYPE``, then the motion
    VAE's target name; YAML's unquoted ``no`` parses as False and means
    'no'.  'no' diffuses raw motion; any other value builds the motion
    VAE of ``model.motion_vae``, as JAX does."""
    v = model.get("vae_type")
    if v is None:
        try:
            v = cfg.TRAIN.ABLATION.get("VAE_TYPE")
        except (KeyError, AttributeError):
            pass
    if v is None:
        return str(model.motion_vae.target).split(".")[-1].lower().replace(
            "vae", "")
    return "no" if v is False else str(v)


def from_cfg(cfg, stage: Optional[str] = None) -> Dict:
    """A merged config (``load_config``) as the port's config dict.

    ``stage`` (default ``TRAIN.STAGE``) names the modules built: the knobs
    of the denoiser and the encoders are checked unless it is 'vae', which
    builds the VAE alone.  The compute dtype is not part of the dict: the
    entry points take it."""
    stage = str(stage or cfg.TRAIN.STAGE)
    model = cfg.model
    predict_epsilon = bool(cfg.TRAIN.ABLATION.PREDICT_EPSILON)

    vae_type = _vae_type(model, cfg)
    tpu = _tpu(cfg)

    vae = _params(model.motion_vae)
    if vae_type != "no":
        # no VAE is built on raw motion: its knobs are not read
        _check_transformer("motion_vae", vae, VAE_ARCHS)
    ds = cfg.DATASET[str(cfg.TRAIN.DATASETS[0]).upper()]
    out = {
        "latent_dim": [int(v) for v in model.latent_dim],
        # serving injects the production geometry when no dataset filled
        # it in (serving.py:497-499)
        "nfeats": int(cfg.DATASET.get("NFEATS") or 189),
        "max_len": int(cfg.DATASET.SAMPLER.MAX_LEN),
        "text_pad_len": int(cfg.get("TPU", {}).get("TEXT_PAD_LEN", 64)),
        "guidance_scale": float(model.guidance_scale),
        "guidance_uncondp": float(model.guidance_uncondp),
        "fps": int(ds.FPS),
        "predict_epsilon": predict_epsilon,
        "vae_type": vae_type,
        "motion_vae": {**_transformer(vae, (
            "arch", "ff_size", "num_layers", "num_heads", "normalize_before",
            "activation", "position_embedding", "dropout")),
            # factory.py:62 reads it from the VAE's ablation block
            "mlp_dist": bool(cfg.TRAIN.ABLATION.get("MLP_DIST", False))},
        **tpu,
    }

    den = _params(model.denoiser)
    te = _params(model.text_encoder)
    ae = _params(model.audio_encoder)
    if stage != "vae":
        _check_transformer("denoiser", den, DENOISER_ARCHS)
        if str(den.get("arch", "trans_dec")) == "trans_dec" and \
                not bool(den.get("normalize_before", True)):
            raise _unsupported("model.denoiser.params.normalize_before",
                               False, "the trans_dec layers are pre-norm "
                               "(JAX asserts, ops/transformer.py:282)")
        if bool(cfg.TRAIN.ABLATION.get("CAUSAL_ATTN", False)):
            # JAX raises ValueError: the reference's knob fails in torch
            # (factory.py:106-116)
            raise ValueError(
                "TRAIN.ABLATION.CAUSAL_ATTN=True is not supported: the "
                "reference implementation of this knob raises")
        for key in ("finetune", "last_hidden_state"):
            if bool(te.get(key, False)):
                raise _unsupported(f"model.text_encoder.params.{key}", True)
        # the audio MLP keeps the module's rate: the JAX factory passes none
        # (factory.py:164-173)
        if float(ae.get("dropout", 0.1)) != 0.1:
            raise _unsupported("model.audio_encoder.params.dropout",
                               ae["dropout"])
        for name, params in (("text_encoder", te), ("audio_encoder", ae)):
            if "compute_dtype" in params:
                raise _unsupported(f"model.{name}.params.compute_dtype",
                                   params["compute_dtype"],
                                   "pass dtype= to the port's entry point")
    # audioenc.audio_num_frames (convofusion_tpu/models/audioenc.py:14-17)
    out["mel_frames"] = int(
        (int(ae.get("max_seq_len", 128)) / int(ae.get("fps", 25)))
        * int(ae.get("sample_rate", 16000))
        // int(ae.get("hop_length", 512)) + 1)
    out["denoiser"] = {
        **_transformer(den, (
            "text_encoded_dim", "ff_size", "num_layers", "num_heads",
            "normalize_before", "activation", "flip_sin_to_cos",
            "position_embedding", "dropout")),
        "arch": str(den.get("arch", "trans_dec")),
        # the pipeline feeds the five streams whatever the name; trans_enc
        # with a one-tensor condition raises where the model is built
        "condition": str(den.get("condition", "text+audio")),
        "freq_shift": float(den.get("freq_shift", 0.0)),
        "fuse_streams": bool(den.get("fuse_streams", False)),
        # per-layer rematerialisation: the denoiser's own flag or TPU.REMAT
        # (convofusion.py:149-153)
        "remat": bool(den.get("remat", False))
        or bool(cfg.get("TPU", {}).get("REMAT", False)),
    }
    # the t5-base dims are the factory's defaults (factory.py:141-161)
    out["text_encoder"] = {
        "latent_dim": int(te.get("latent_dim", 512)),
        "vocab_size": int(te.get("vocab_size", 32128)),
        "d_model": int(te.get("d_model", 768)),
        "d_ff": int(te.get("d_ff", 3072)),
        "num_layers": int(te.get("num_layers", 12)),
        "num_heads": int(te.get("num_heads", 12)),
        "d_kv": int(te.get("d_kv", 64)),
        # the trunk's dropout, applied in the stage-2 loss (factory.py:158)
        "dropout": float(te.get("dropout", 0.0)),
    }
    out["audio_encoder"] = {
        "input_size": int(ae.get("input_size", 80)),
        "hidden_size": int(ae.get("hidden_size", 256)),
        "latent_dim": int(ae.get("latent_dim", 512)),
        "dropout": 0.1,
    }
    out["scheduler"] = _scheduler(model.scheduler, predict_epsilon,
                                  "scheduler", True)
    out["noise_scheduler"] = _scheduler(model.noise_scheduler,
                                        predict_epsilon, "noise_scheduler",
                                        False)
    out["t5_path"] = str(te.get("modelpath", "t5-base"))
    out["weg_type"] = ablation_flag(cfg, "WEG_TYPE")
    wp = model.get("weg_parameters", {})
    out["weg_parameters"] = wp.to_container() if hasattr(
        wp, "to_container") else dict(wp)
    out["serve"] = _serve(cfg)
    out["train"] = _train(cfg, vae, ds)
    return out


def tiny_config(stage: str = "diffusion", latent_dim: int = 32,
                text_dim: int = 64, num_layers: int = 3,
                text_pad_len: int = 16):
    """Small-dimension merged config with the production topology
    (convofusion_tpu/config/testing.py:10-36)."""
    cfg_file = ("config_cf_beatdnd.yaml" if stage != "vae"
                else "config_vae_beatdnd.yaml")
    cfg = load_config(os.path.join(DEFAULTS_DIR, cfg_file))
    cfg.TRAIN.STAGE = stage
    cfg.DEBUG = False
    cfg.model.latent_dim = [1, latent_dim]
    cfg.DATASET.NFEATS = 189
    cfg.DATASET.NJOINTS = 63
    cfg.model.motion_vae.params.num_layers = num_layers
    cfg.model.motion_vae.params.ff_size = 64
    cfg.model.motion_vae.params.dropout = 0.0
    cfg.model.denoiser.params.num_layers = num_layers
    cfg.model.denoiser.params.ff_size = 64
    cfg.model.denoiser.params.dropout = 0.0
    cfg.model.denoiser.params.text_encoded_dim = text_dim
    cfg.model.denoiser.params.audio_encoded_dim = text_dim
    cfg.model.text_encoder.params.latent_dim = text_dim
    cfg.model.audio_encoder.params.latent_dim = text_dim
    for k, v in dict(d_model=32, d_ff=64, num_layers=2, num_heads=4,
                     d_kv=8, vocab_size=1000).items():
        cfg.model.text_encoder.params[k] = v
    cfg.TPU.TEXT_PAD_LEN = text_pad_len
    return cfg
