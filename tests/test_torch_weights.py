"""Weights between the JAX package and the PyTorch port.

- ``state_dict_from_jax`` followed by the JAX package's own converters
  (``compat/torch_loader``, ``models/t5.t5_params_from_torch``) gives back
  the original JAX tree, bit for bit, the VAE encoder included, for a
  stage-2 tree and for a stage-1 (VAE-only) one;
- unknown JAX keys raise;
- at production geometry the port has, module by module, exactly the
  parameter count of the JAX tree (``jax.eval_shape``, no compute);
- importing the port pulls in neither JAX nor the JAX package.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.compat import torch_loader as tl
from convofusion_tpu.config import DEFAULTS_DIR, load_config
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu.models.t5 import t5_params_from_torch
from convofusion_tpu.models.tokenizer import WordHashTokenizer
from convofusion_tpu_torch.compat.from_jax import (
    _flatten,
    state_dict_from_jax,
)
from convofusion_tpu_torch.config import PRODUCTION, TINY, TINY_VAE
from convofusion_tpu_torch.models.convofusion import Convofusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    return params, sd


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_same_tree(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_round_trip_through_jax_converters(tiny):
    params, sd = tiny
    _assert_same_tree(tl.denoiser_params(_sub(sd, "denoiser."), 64, 3),
                      params["denoiser"])
    _assert_same_tree(tl.vae_params(_sub(sd, "vae."), 32, 3), params["vae"])
    _assert_same_tree(
        t5_params_from_torch(_sub(sd, "text_encoder.text_model."), 2),
        params["text_encoder"]["text_model"])
    _assert_same_tree(tl.linear(sd, "text_encoder.projection.1"),
                      params["text_encoder"]["projection_1"])


def test_stage1_tree_round_trip():
    """A tree with the VAE alone loads into a stage='vae' model and comes
    back through the JAX converter unchanged."""
    jm = JaxConvofusion(tiny_config("vae"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    assert set(params) == {"vae"}
    tm = Convofusion(TINY_VAE, device="cpu", seed=None, stage="vae")
    tm.load_state_dict(state_dict_from_jax(params))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    _assert_same_tree(tl.vae_params(_sub(sd, "vae."), 32, 3), params["vae"])


def test_unknown_key_raises(tiny):
    params, _ = tiny
    bad = dict(params)
    bad["denoiser"] = dict(params["denoiser"])
    bad["denoiser"]["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        state_dict_from_jax(bad)
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax({k: v for k, v in params.items()
                             if k != "audio_encoder"})


def test_production_parameter_count_matches_jax():
    """Full width, pinned cheaply: the port built on the meta device, the
    JAX tree by eval_shape."""
    cfg = load_config(os.path.join(DEFAULTS_DIR, "config_cf_beatdnd.yaml"))
    cfg.DATASET.NFEATS = 189
    cfg.DATASET.NJOINTS = 63
    jm = JaxConvofusion(cfg, tokenizer=WordHashTokenizer(max_length=64))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    with torch.device("meta"):
        tm = Convofusion(PRODUCTION, device="meta", seed=None)
    for name in ("denoiser", "text_encoder", "audio_encoder",
                 "condition_fuser", "vae"):
        want = sum(int(np.prod(s.shape))
                   for s in _flatten_shapes(shapes[name], name).values())
        got = sum(p.numel() for p in getattr(tm, name).parameters())
        assert got == want, name
    assert sum(p.numel() for p in tm.parameters()) > 200e6


def _flatten_shapes(tree, prefix):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten_shapes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imported: neither JAX
    nor the JAX package comes along, the config system, the checkpoints,
    the asset drop, the tokenizers, the data pipeline, the test CLI, the
    learning proof, the fused streams, the model-type dispatch, the mask
    helpers and the data-parallel mesh included (each keeps its own copy),
    and neither do the
    tokenizer packages the JAX side uses as its oracle."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import convofusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "need = ['convofusion_tpu_torch.' + m for m in ('config', "
        "'config.omega', 'config.from_yaml', 'train.checkpoint', "
        "'utils.assets', 'serving', 'models.sentencepiece', "
        "'models.tokenizer', 'data.text', 'data.audio', 'native', "
        "'data.dataset', 'data.collate', 'data.datamodule', "
        "'data.fixture', 'utils.quaternion', 'utils.geometry', "
        "'utils.logger', 'utils.profiling', 'cli.test', 'train.overfit', "
        "'train.sampler_quality', 'ops.fused_streams', 'models.get_model', "
        "'utils.masks', 'parallel', 'parallel.mesh')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'convofusion_tpu', "
        "'tokenizers', 'transformers', 'sentencepiece')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
