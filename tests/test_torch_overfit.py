"""The port's learning-proof harness (``train/overfit.py``) against the JAX
package's (``convofusion_tpu/train/overfit.py``), and the committed proof
that the port learns.

- the experiment and assets YAMLs ``write_cfg`` writes for both stages and
  for the reproduction, generation and sampler-quality dumps equal JAX's,
  paths aside; the port's experiment file adds ``TPU.COMPUTE_DTYPE:
  float32``, the dtype JAX's CLI computes in;
- ``DEFAULT_THRESHOLDS`` is JAX's dict, and ``_check_thresholds`` reports
  the same failures;
- ``reproduction_metrics`` of one synthetic dump tree equals JAX's within
  1e-12 (float64 numpy on both sides);
- ``vae_recon_error`` of one stage-1 checkpoint (the port's seeded VAE,
  written by each package's own ``save_checkpoint``) within 1e-5 of JAX's,
  fp32 forwards over the same fixture clips;
- the committed ``docs/artifacts/overfit_result_torch.json``, a run of the
  full proof on the card, clears ``DEFAULT_THRESHOLDS`` (as
  tests/test_learning.py holds JAX's artifact) and names the card.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from convofusion_tpu.train import overfit as jax_overfit
from convofusion_tpu_torch.config import from_cfg, parse_args
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train import checkpoint as ck
from convofusion_tpu_torch.train import overfit

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                         "artifacts")
RECON_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overfit"))
    return (root,) + overfit.build_fixture(root)


def _write(module, root, name, **kw):
    beat, dnd = os.path.join(root, "beat"), os.path.join(root, "dnd")
    paths = module.write_cfg(root, beat, dnd, name, **kw)
    out = []
    for p in paths:
        with open(p) as f:
            text = f.read().replace(root, "<root>")
        out.append(yaml.safe_load(text))
    return out


CONFIGS = {
    "stage1": dict(stage="vae", epochs=2000, batch=7, lr=1e-3),
    "stage2": dict(stage="diffusion", epochs=10000, batch=8, lr=1e-3,
                   extra={"TRAIN": {"PRETRAINED_VAE": "/v/epoch=1999"}}),
    "repro": dict(stage="diffusion", epochs=1, batch=8, lr=1e-3,
                  extra={"TEST": {"CHECKPOINTS": "/d/epoch=9999"},
                         "model": {"guidance_scale": 1.0}}),
    "gen": dict(stage="diffusion", epochs=1, batch=8, lr=1e-3,
                extra={"TEST": {"CHECKPOINTS": "/d/epoch=9999"}}),
    "dpmpp15": dict(stage="diffusion", epochs=1, batch=8, lr=1e-3,
                    infer_steps=15, extra={
                        "TEST": {"CHECKPOINTS": "/d/epoch=9999"},
                        "model": {"guidance_scale": 1.0, "scheduler": {
                            "variant": "dpmpp_2m",
                            "num_inference_timesteps": 15}}}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_write_cfg_matches_jax(tmp_path, name):
    kw = CONFIGS[name]
    root_j, root_p = str(tmp_path / "j"), str(tmp_path / "p")
    for r in (root_j, root_p):
        os.makedirs(r)
    cfg_j, assets_j = _write(jax_overfit, root_j, name, **copy.deepcopy(kw))
    cfg_p, assets_p = _write(overfit, root_p, name, **copy.deepcopy(kw))
    assert cfg_p["TPU"].pop("COMPUTE_DTYPE") == "float32"
    assert cfg_p == cfg_j
    assert assets_p == assets_j
    # the geometry and the scheduler ride the file that merges last
    assert assets_p["model"]["denoiser"]["params"]["num_layers"] == 3
    assert assets_p["model"]["scheduler"]["params"] == {"clip_sample": False}


def test_write_cfg_leaves_scales_alone(tmp_path):
    """``extra['model']`` is merged into a copy of the scale's geometry
    (JAX's merge writes into ``SCALES`` itself)."""
    before = copy.deepcopy(overfit.SCALES)
    overfit.write_cfg(str(tmp_path), "b", "d", "x", stage="diffusion",
                      epochs=1, batch=8, lr=1e-3, extra={"model": {
                          "denoiser": {"params": {"fuse_streams": True}}}})
    assert overfit.SCALES == before


def test_thresholds_equal_jax():
    assert overfit.DEFAULT_THRESHOLDS == jax_overfit.DEFAULT_THRESHOLDS


@pytest.mark.parametrize("out", [
    {"vae_recon_rel_rmse": 0.1, "repro": {"retrieval_top1": 1.0,
                                          "margin": 5.0}},
    {"vae_recon_rel_rmse": 0.2, "repro": {"retrieval_top1": 0.5,
                                          "margin": 1.0}},
    {"vae_recon_rel_rmse": 0.1},
    {"repro": {"retrieval_top1": 1.0, "margin": 2.5},
     "diff_final_loss": 0.3},
], ids=["pass", "all_fail", "missing", "margin_and_loss"])
def test_check_thresholds_reports_as_jax(out):
    thresholds = dict(overfit.DEFAULT_THRESHOLDS, diff_final_loss=0.25)

    def failures(module):
        try:
            module._check_thresholds(out, thresholds)
        except AssertionError as e:
            return str(e)
        return None

    assert failures(overfit) == failures(jax_overfit)


def test_reproduction_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    gts = rng.standard_normal((6, 128, 63, 3)).astype(np.float32)
    for i, gt in enumerate(gts):
        d = tmp_path / f"set_{i % 2}" / f"item_{i}"
        d.mkdir(parents=True)
        np.save(d / "gt.npy", gt)
        np.save(d / "pred.npy", gt + 0.3 * rng.standard_normal(
            gt.shape).astype(np.float32))
    got = overfit.reproduction_metrics(str(tmp_path))
    want = jax_overfit.reproduction_metrics(str(tmp_path))
    assert set(got) == set(want) and got["n_samples"] == 6
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k


def test_vae_recon_error_matches_jax(fixture_root):
    """One stage-1 checkpoint, written by each package's
    ``save_checkpoint`` from the port's seeded VAE (JAX's tree through
    ``compat/torch_loader``)."""
    from convofusion_tpu.compat import torch_loader as tl
    from convofusion_tpu.train.checkpoint import save_checkpoint

    root, beat, dnd = fixture_root
    kw = dict(stage="vae", epochs=1, batch=7, lr=1e-3)
    cfg_p, assets_p = overfit.write_cfg(root, beat, dnd, "recon_p", **kw)
    cfg_j, assets_j = jax_overfit.write_cfg(root, beat, dnd, "recon_j", **kw)
    cfg = parse_args("test", ["--cfg", cfg_p, "--cfg_assets", assets_p])
    model = Convofusion(from_cfg(cfg, stage="vae"), device="cpu", seed=3,
                        stage="vae")
    ckpt_p = ck.save_checkpoint(os.path.join(root, "ck_p"), 0, model)
    sd = {k[len("vae."):]: v.numpy() for k, v in model.state_dict().items()}
    params = {"vae": tl.vae_params(sd, 32, 3)}
    ckpt_j = save_checkpoint(os.path.join(root, "ck_j"), 0, params)

    got = overfit.vae_recon_error(cfg_p, assets_p, ckpt_p, device="cpu")
    want = jax_overfit.vae_recon_error(cfg_j, assets_j, ckpt_j)
    assert 0.5 < want < 2.0          # an untrained VAE: no reconstruction
    assert abs(got - want) <= RECON_TOL, (got, want)


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}/")
    return out


def test_committed_artifact_passes_thresholds():
    """The port's full proof on the card, at JAX's default budgets."""
    with open(os.path.join(ARTIFACTS, "overfit_result.json")) as f:
        jax_art = json.load(f)
    with open(os.path.join(ARTIFACTS, "overfit_result_torch.json")) as f:
        out = json.load(f)
    overfit._check_thresholds(out, overfit.DEFAULT_THRESHOLDS)
    assert _keys(jax_art) <= _keys(out)
    assert (out["vae_epochs"], out["diff_epochs"]) == (2000, 10000)
    assert "H100" in out["card"] and out["compute_dtype"] == "float32"
    assert out["repro_untrained"]["retrieval_top1"] < 0.5


def test_committed_sampler_quality_artifact():
    with open(os.path.join(ARTIFACTS, "sampler_quality_trained.json")) as f:
        jax_art = json.load(f)
    with open(os.path.join(ARTIFACTS,
                           "sampler_quality_trained_torch.json")) as f:
        out = json.load(f)
    assert _keys(jax_art) <= _keys(out)
    assert "H100" in out["card"]
    assert out["ddim50"]["motion_rmse_vs_ddim50_over_std"] == 0.0
