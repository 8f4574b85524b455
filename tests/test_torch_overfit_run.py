"""The port's learning proof (``train/overfit.run``) end to end on the CPU
at a token budget: 2 + 2 epochs, DDIM-3.  Every stage runs through the
port's CLIs (``cli/train`` twice, ``cli/test`` three times, ``eval/run``
twice); the result has every key of the JAX package's committed
``docs/artifacts/overfit_result.json``, with finite numbers.  Then the
trained-weights sampler check (``train/sampler_quality``) on the run's
stage-2 checkpoint, at 3 and 2 steps, has every key a sampler has in JAX's
``docs/artifacts/sampler_quality_trained.json``.
"""
import json
import math
import os

import pytest
import torch

from convofusion_tpu_torch.train import overfit, sampler_quality

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                         "artifacts")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_run_at_a_token_budget(tmp_path):
    with open(os.path.join(ARTIFACTS, "overfit_result.json")) as f:
        want = json.load(f)
    out = overfit.run(str(tmp_path), vae_epochs=2, diff_epochs=2,
                      infer_steps=3, device="cpu", log=lambda *a: None)
    got = dict(_leaves(out))
    for key, value in _leaves(want):
        assert key in got, key
        if isinstance(value, (int, float)):
            assert math.isfinite(got[key]), key
    assert out["card"] == "cpu"
    assert set(out["stage_seconds"]) == {
        "vae_train", "diff_train", "repro_dump", "gen_dump",
        "untrained_dump"}
    with open(tmp_path / "overfit_result.json") as f:
        assert json.load(f) == out

    with open(os.path.join(ARTIFACTS, "sampler_quality_trained.json")) as f:
        jax_squal = json.load(f)
    squal = sampler_quality.trained_main(
        str(tmp_path), out["diff_ckpt"], device="cpu",
        samplers=(("ddim3", "ddim", 3), ("dpmpp2", "dpmpp_2m", 2)))
    assert set(squal) == {"ddim3", "dpmpp2"}
    assert squal["ddim3"]["motion_rmse_vs_ddim50_over_std"] == 0.0
    for row in squal.values():
        assert set(jax_squal["ddim50"]) <= set(row)
        assert set(row["repro"]) == set(jax_squal["ddim50"]["repro"])
        assert row["repro"]["n_samples"] == 8
