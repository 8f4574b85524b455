"""The denoiser variants through the port's CLIs on the learning proof's
fixture (``train/overfit.build_fixture``), small geometry, fp32, on the
CPU: diffusion on raw motion (``TRAIN.ABLATION.VAE_TYPE: no``) and the
fused-stream denoiser with ``TPU.REMAT``.

Each variant trains one stage-2 epoch through ``cli/train``, resumes a
second from ``epoch=0.ckpt`` (``TRAIN.RESUME``), and samples the test
split from ``epoch=1.ckpt`` through ``cli/test`` at DDIM-3.  On raw motion
the VAE posterior cache stays off (JAX cli/train.py:167-170), the
checkpoints hold no ``vae.`` weight, and ``TRAIN.PRETRAINED_VAE`` has no
VAE to go into: the port warns (JAX adds the tree unused).
"""
import os

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.cli import test as cli_test
from convofusion_tpu_torch.cli import train as cli_train
from convofusion_tpu_torch.train.overfit import build_fixture, write_cfg

VARIANTS = {
    "raw_motion": {
        "TRAIN": {"ABLATION": {"VAE_TYPE": "no"},
                  "PRETRAINED_VAE": "/nonexistent/epoch=0.ckpt"},
        "model": {"latent_dim": [1, 189]},
    },
    "fused_remat": {
        "TPU": {"REMAT": True},
        "model": {"denoiser": {"params": {"fuse_streams": True}}},
    },
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("variants"))
    return (root,) + build_fixture(root)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_trains_resumes_and_samples(fixture_trees, variant):
    root, beat, dnd = fixture_trees
    cfg, assets = write_cfg(root, beat, dnd, variant, stage="diffusion",
                            epochs=1, batch=8, lr=1e-3, infer_steps=3,
                            extra=VARIANTS[variant])
    argv = ["--cfg", cfg, "--cfg_assets", assets, "--device", "cpu"]
    if variant == "raw_motion":
        with pytest.warns(UserWarning, match="raw motion"):
            model = cli_train.main(argv)
        assert model.vae is None and model.latent_tokens == 128
    else:
        model = cli_train.main(argv)
        assert model.fuse_streams and model.denoiser.decoder.remat
    stats = model.train_stats.epochs[0]
    assert ("posterior_hits" in stats) == (variant != "raw_motion")
    ckpts = os.path.join(root, "experiments", "convofusion", variant,
                         "checkpoints")
    sd = torch.load(os.path.join(ckpts, "epoch=0.ckpt"),
                    weights_only=True)["state_dict"]
    assert any(k.startswith("vae.") for k in sd) == (
        variant != "raw_motion")
    assert any(".cross_streams." in k for k in sd) == (
        variant == "fused_remat")

    resumed = cli_train.main(argv + ["TRAIN.END_EPOCH=2",
                                     "TRAIN.RESUME=true"])
    assert resumed.train_stats.start_epoch == 1
    last = resumed.train_stats.epochs[-1]
    assert last["epoch"] == 1 and last["steps"] >= 1

    run = cli_test.main(argv + [
        f"TEST.CHECKPOINTS={os.path.join(ckpts, 'epoch=1.ckpt')}"])
    preds = [np.load(os.path.join(d, "pred.npy"))
             for d, _, files in os.walk(run.out_dir) if "pred.npy" in files]
    assert len(preds) == 8
    for p in preds:
        assert p.shape == (128, 63, 3) and np.isfinite(p).all()
