"""The port's YAML config system against the JAX package's.

- the nine YAML copies are byte-equal to their sources;
- the port's ``load_config`` / ``tiny_config`` give the containers of
  ``convofusion_tpu.config`` (whose config modules import no JAX) on the
  same files and overrides;
- ``from_cfg`` of the experiment files equals ``config.PRODUCTION`` /
  ``PRODUCTION_VAE`` / ``TINY`` / ``TINY_VAE``, the dicts whose comments
  cite the same YAML lines; the exceptions are named in each test;
- ``ablation_flag`` maps YAML's bare ``no`` (boolean False) to ``'no'``;
- a knob the port does not implement, or where JAX raises, raises and
  names its key; the ablations JAX runs (MLP_DIST, learned PEs, the VAE's
  post-norm, all_encoder, trans_enc, another model.condition,
  TPU.PALLAS_STEP, TPU.SCAN_UNROLL), the fused streams, REMAT and
  raw-motion diffusion are read into the dict.
No JAX model is built: the comparisons are of config containers.
"""
import copy
import os

import pytest

from convofusion_tpu import config as jax_config
from convofusion_tpu.config import testing as jax_testing
from convofusion_tpu_torch import config as C

EXPERIMENTS = ("config_cf_beatdnd.yaml", "config_vae_beatdnd.yaml")
YAMLS = ("base.yaml", "assets.yaml") + EXPERIMENTS + tuple(
    f"modules/{m}.yaml" for m in ("audio_encoder", "denoiser", "motion_vae",
                                  "scheduler", "text_encoder"))
DDIM_50 = ["model.scheduler.variant=ddim",
           "model.scheduler.num_inference_timesteps=50"]


def _load(name, overrides=None, **kw):
    return C.load_config(os.path.join(C.DEFAULTS_DIR, name),
                         overrides=overrides, **kw)


@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_copies_are_byte_equal(rel):
    with open(os.path.join(jax_config.DEFAULTS_DIR, rel), "rb") as f:
        want = f.read()
    with open(os.path.join(C.DEFAULTS_DIR, rel), "rb") as f:
        assert f.read() == want


def test_the_copies_are_every_yaml_of_the_source():
    found = sorted(os.path.relpath(os.path.join(d, f), jax_config.DEFAULTS_DIR)
                   for d, _, files in os.walk(jax_config.DEFAULTS_DIR)
                   for f in files if f.endswith(".yaml"))
    assert found == sorted(YAMLS)


@pytest.mark.parametrize("name", EXPERIMENTS)
@pytest.mark.parametrize("overrides,phase", [
    (None, "train"),
    (DDIM_50 + ["TEST.CHECKPOINTS=/x/epoch=3.ckpt", "SERVE.PORT=0",
                "TRAIN.ABLATION.WEG_TYPE=no", "DEBUG=true"], "test"),
    (["DEBUG=true", "model.weg_parameters.thresholds.0=0.5"], "train"),
])
def test_load_config_matches_jax(name, overrides, phase):
    path = os.path.join(C.DEFAULTS_DIR, name)
    got = C.load_config(path, overrides=overrides, phase=phase)
    want = jax_config.load_config(path, overrides=overrides, phase=phase)
    assert got.to_container() == want.to_container()
    assert got.to_container(resolve=False) == want.to_container(resolve=False)


@pytest.mark.parametrize("stage", ["diffusion", "vae"])
def test_tiny_config_matches_jax(stage):
    assert (C.tiny_config(stage).to_container()
            == jax_testing.tiny_config(stage).to_container())


def test_parse_args_matches_jax():
    argv = ["--cfg", os.path.join(C.DEFAULTS_DIR, EXPERIMENTS[1]),
            "--batch_size", "8", "--nodebug", "--dir", "out",
            "LOSS.LAMBDA_KL=0.5"]
    got = C.parse_args("test", argv)
    assert got.to_container() == jax_config.parse_args(
        "test", argv).to_container()
    assert got.TRAIN.BATCH_SIZE == 8 and got.LOSS.LAMBDA_KL == 0.5


def _without(cfg, *keys):
    cfg = copy.deepcopy(cfg)
    for k in keys:
        block, _, key = k.partition(".")
        if key:
            del cfg[block][key]
        else:
            del cfg[block]
    return cfg


def test_from_cfg_is_production():
    """The YAML's scheduler is DDPM-1000 (modules/scheduler.yaml:1-11);
    PRODUCTION takes bench.py's DDIM-50, which the overrides give."""
    got = C.from_cfg(_load(EXPERIMENTS[0]))
    assert got["scheduler"]["variant"] == "ddpm"
    assert got["scheduler"]["num_inference_timesteps"] == 1000
    keys = ("scheduler.variant", "scheduler.num_inference_timesteps")
    assert _without(got, *keys) == _without(C.PRODUCTION, *keys)
    assert C.from_cfg(_load(EXPERIMENTS[0], DDIM_50)) == C.PRODUCTION


def test_from_cfg_is_production_vae():
    """Stage 1: PRODUCTION_VAE copies PRODUCTION's stage-2 sampling keys,
    the stage-1 experiment leaves WEG_TYPE at base.yaml's 'no'
    (a flag that stage never reads)."""
    got = C.from_cfg(_load(EXPERIMENTS[1], DDIM_50))
    assert got["weg_type"] == "no"
    assert _without(got, "weg_type") == _without(C.PRODUCTION_VAE,
                                                  "weg_type")
    assert got["train"] == C.TRAIN_VAE


@pytest.mark.parametrize("stage,want", [("diffusion", C.TINY),
                                        ("vae", C.TINY_VAE)])
def test_from_cfg_of_tiny_config_is_tiny(stage, want):
    """TINY turns WEG off; tiny_config keeps the stage-2 experiment's
    'semantic' (the stage-1 one has base.yaml's 'no')."""
    got = C.from_cfg(C.tiny_config(stage))
    assert got["weg_type"] == ("semantic" if stage == "diffusion" else "no")
    assert _without(got, "weg_type") == _without(want, "weg_type")


def test_ablation_flag_maps_yaml_no():
    cfg = C.OmegaConf.create({"TRAIN": {"ABLATION": {"WEG_TYPE": False,
                                                     "OTHER": True}}})
    assert C.ablation_flag(cfg, "WEG_TYPE") == "no"
    assert C.ablation_flag(cfg, "OTHER") == "yes"
    assert C.ablation_flag(cfg, "MISSING") == "no"
    loaded = C.OmegaConf.from_dotlist(["TRAIN.ABLATION.WEG_TYPE=no"])
    assert loaded.TRAIN.ABLATION.WEG_TYPE is False      # the YAML-1.1 trap
    assert C.ablation_flag(loaded, "WEG_TYPE") == "no"
    got = C.from_cfg(_load(EXPERIMENTS[0], ["TRAIN.ABLATION.WEG_TYPE=no"]))
    assert got["weg_type"] == "no"


def test_serve_block_and_optimizer_knobs():
    got = C.from_cfg(_load(EXPERIMENTS[0], [
        "SERVE.BATCH_SIZE=4", "SERVE.MAX_WAIT_MS=7", "SERVE.MAX_QUEUE=0",
        "SERVE.HOST=0.0.0.0", "SERVE.PORT=9", "SEED_VALUE=5",
        "TRAIN.OPTIM.SCHEDULE=cosine", "TRAIN.OPTIM.WARMUP_STEPS=3",
        "TRAIN.OPTIM.GRAD_CLIP=1.0", "LOSS.LAMBDA_PRIOR=0.5",
        "TPU.TEXT_PAD_LEN=32", "DATASET.NFEATS=0"]))
    assert got["serve"] == {"batch_size": 4, "max_wait_ms": 7.0,
                            "max_queue": 0, "seed": 5, "weg_max_focus": 8,
                            "host": "0.0.0.0", "port": 9}
    assert got["train"]["optim"]["schedule"] == "cosine"
    assert got["train"]["optim"]["warmup_steps"] == 3
    assert got["train"]["optim"]["grad_clip"] == 1.0
    assert got["train"]["loss"]["lambda_prior"] == 0.5
    assert got["text_pad_len"] == 32
    assert got["nfeats"] == 189       # serving's default (serving.py:497)


@pytest.mark.parametrize("override,key", [
    ("TRAIN.ABLATION.CAUSAL_ATTN=true", "CAUSAL_ATTN"),
    ("model.denoiser.params.normalize_before=false", "normalize_before"),
    ("TPU.MESH.MODEL=2", "TPU.MESH.MODEL"),
    ("model.scheduler.params.variance_type=fixed_large", "variance_type"),
    ("model.text_encoder.params.finetune=true", "finetune"),
])
def test_unsupported_knob_raises(override, key):
    with pytest.raises(NotImplementedError, match=key):
        C.from_cfg(_load(EXPERIMENTS[0], [override]))


@pytest.mark.parametrize("override,path,want", [
    ("TRAIN.ABLATION.MLP_DIST=true", ("motion_vae", "mlp_dist"), True),
    ("model.motion_vae.params.position_embedding=learned",
     ("motion_vae", "position_embedding"), "learned"),
    ("model.denoiser.params.position_embedding=learned",
     ("denoiser", "position_embedding"), "learned"),
    ("model.motion_vae.params.normalize_before=false",
     ("motion_vae", "normalize_before"), False),
    ("model.motion_vae.params.arch=all_encoder", ("motion_vae", "arch"),
     "all_encoder"),
    ("model.denoiser.params.arch=trans_enc", ("denoiser", "arch"),
     "trans_enc"),
    ("TPU.PALLAS_STEP=false", ("pallas_step",), False),
    ("TPU.SCAN_UNROLL=2", ("scan_unroll",), 2),
    ("model.condition=text", ("denoiser", "condition"), "text"),
])
def test_ablation_knob_builds(override, path, want):
    """A knob that JAX runs goes into the dict, and nothing else moves."""
    got = C.from_cfg(_load(EXPERIMENTS[0], DDIM_50 + [override]))
    node, ref = got, C.PRODUCTION
    for k in path[:-1]:
        node, ref = node[k], ref[k]
    assert node[path[-1]] == want != ref[path[-1]]
    node[path[-1]] = ref[path[-1]]
    assert got == C.PRODUCTION


@pytest.mark.parametrize("override,key", [
    ("model.motion_vae.params.arch=transformer", "motion_vae.params.arch"),
    ("model.denoiser.params.arch=mlp", "denoiser.params.arch"),
    ("model.motion_vae.params.position_embedding=rotary",
     "motion_vae.params.position_embedding"),
])
def test_a_value_jax_rejects_raises(override, key):
    with pytest.raises(ValueError, match=key):
        C.from_cfg(_load(EXPERIMENTS[0], [override]))


def test_stage_one_skips_the_denoiser_knobs():
    """A stage-1 config builds the VAE alone: the denoiser's knobs are not
    its business; the VAE's still are (its post-norm builds)."""
    cfg = _load(EXPERIMENTS[1],
                ["model.denoiser.params.normalize_before=false"])
    assert C.from_cfg(cfg)["motion_vae"] == C.PRODUCTION_VAE["motion_vae"]
    post = C.from_cfg(_load(EXPERIMENTS[1], [
        "model.motion_vae.params.normalize_before=false"]))
    assert post["motion_vae"] == {**C.PRODUCTION_VAE["motion_vae"],
                                  "normalize_before": False}
    with pytest.raises(ValueError, match="arch"):
        C.from_cfg(_load(EXPERIMENTS[1], [
            "model.motion_vae.params.arch=transformer"]))
    with pytest.raises(NotImplementedError, match="normalize_before"):
        C.from_cfg(cfg, stage="diffusion")


@pytest.mark.parametrize("overrides,path,want", [
    (["model.denoiser.params.fuse_streams=true"],
     ("denoiser", "fuse_streams"), True),
    (["model.denoiser.params.remat=true"], ("denoiser", "remat"), True),
    (["TPU.REMAT=true"], ("denoiser", "remat"), True),
    (["TRAIN.ABLATION.VAE_TYPE=no"], ("vae_type",), "no"),
    (["TRAIN.ABLATION.VAE_TYPE='no'"], ("vae_type",), "no"),
    (["model.vae_type=no", "TRAIN.ABLATION.VAE_TYPE=convofusion"],
     ("vae_type",), "no"),
    ([], ("vae_type",), "convofusion"),
])
def test_ported_knob_is_read(overrides, path, want):
    """``fuse_streams``, ``remat``, ``TPU.REMAT`` and ``VAE_TYPE: no``
    reach the dict (JAX convofusion.py:84-110, :149-153): ``model.vae_type``
    wins over ``TRAIN.ABLATION.VAE_TYPE``, YAML's unquoted ``no`` (False)
    reads 'no'; the rest of the dict is PRODUCTION's."""
    got = C.from_cfg(_load(EXPERIMENTS[0], DDIM_50 + overrides))
    node = got
    for key in path:
        node = node[key]
    assert node == want
    want_dict = copy.deepcopy(C.PRODUCTION)
    node = want_dict
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = want
    assert got == want_dict


def test_raw_motion_geometry_is_not_refused():
    """The no-VAE geometry (latent_dim [1, 189]) and a VAE knob the port
    refuses are not checked when no VAE is built."""
    got = C.from_cfg(_load(EXPERIMENTS[0], [
        "TRAIN.ABLATION.VAE_TYPE=no", "model.latent_dim=[1,189]",
        "model.motion_vae.params.normalize_before=false"]))
    assert got["vae_type"] == "no" and got["latent_dim"] == [1, 189]
