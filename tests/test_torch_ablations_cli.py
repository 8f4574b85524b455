"""The ablations through the port's checkpoints and entry points, small
geometry, on the CPU:

- save / load / resume of an ablated model (the post-norm, learned-PE,
  MLP_DIST VAE; the all_encoder VAE; the trans_enc denoiser) with dropout
  0.1: 2 steps + save + load + 2 steps equal 4 straight steps bit for bit;
- a reference-layout ``.ckpt`` with MLP_DIST heads loads whole
  (``load_torch_full_model``) and as a stage-1 VAE (``load_torch_vae``),
  bit-equal; a model without the heads refuses it;
- an ablation config through the CLIs on the learning proof's fixture:
  ``cli/train`` stage 1 with the ablated VAE, stage 2 from its file,
  ``cli/test`` with ``TPU.PALLAS_STEP: false`` and the service built from
  the merged config and the stage-2 file;
- ``models/get_model`` and ``utils/masks``.
"""
import copy
import os

import numpy as np
import pytest
import torch

from convofusion_tpu_torch import config as C
from convofusion_tpu_torch.cli import test as cli_test
from convofusion_tpu_torch.cli import train as cli_train
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.get_model import get_model
from convofusion_tpu_torch.serving import GestureRequest, build_service
from convofusion_tpu_torch.train import checkpoint as ck
from convofusion_tpu_torch.train.overfit import build_fixture, write_cfg
from convofusion_tpu_torch.train.trainer import Trainer
from convofusion_tpu_torch.utils.masks import lengths_to_mask, remove_padding

ABLATED_VAE = {"normalize_before": False, "position_embedding": "learned",
               "mlp_dist": True}
CASES = {
    "ablated_vae": ("vae", {"motion_vae": ABLATED_VAE}),
    "ablated": ("diffusion", {"motion_vae": ABLATED_VAE,
                              "denoiser": {"position_embedding": "learned"}}),
    "all_encoder": ("vae", {"motion_vae": {"arch": "all_encoder"}}),
    "trans_enc": ("diffusion", {"denoiser": {"arch": "trans_enc"},
                                "guidance_scale": 1.0}),
}
B = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_config(case):
    """TINY (TINY_VAE for stage 1) with the case's knobs and dropout 0.1 in
    the VAE and the denoiser."""
    stage, knobs = CASES[case]
    cfg = copy.deepcopy(C.TINY_VAE if stage == "vae" else C.TINY)
    cfg["motion_vae"]["dropout"] = cfg["denoiser"]["dropout"] = 0.1
    for key, value in knobs.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    return stage, cfg


def _batch(stage, model):
    raw = synthetic_raw_batch(0, B)
    if stage == "vae":
        return {"motion": torch.from_numpy(raw["motion_lsn"])}
    return prepare_arrays(model, raw)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equals_straight_steps(tmp_path, case):
    stage, cfg = case_config(case)

    def fresh():
        model = Convofusion(cfg, device="cpu", seed=16, stage=stage)
        return model, Trainer(model)

    model, trainer = fresh()
    data = _batch(stage, model)
    straight = trainer.fit_steps([data] * 4,
                                 torch.Generator().manual_seed(17))
    model, trainer = fresh()
    gen = torch.Generator().manual_seed(17)
    first = trainer.fit_steps([data] * 2, gen)
    path = ck.save_checkpoint(str(tmp_path), 2, model, trainer, gen)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model, trainer = fresh()
    gen = torch.Generator()
    ck.load_checkpoint(path, model, trainer, gen)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert first + trainer.fit_steps([data] * 2, gen) == straight


def test_reference_layout_with_dist_heads_loads(tmp_path):
    _, cfg = case_config("ablated")
    src = Convofusion(cfg, device="cpu", seed=21)
    sd = src.state_dict()
    assert {"vae.body_dist_layer.weight", "vae.hands_dist_layer.bias",
            "vae.query_pos_encoder.pe", "denoiser.mem_pos.pe"} <= set(sd)
    path = str(tmp_path / "reference.ckpt")
    # the released files' layout: the encoders under text_audio_encoder.
    torch.save({"state_dict": ck._to_reference_names(
        {k: v.clone() for k, v in sd.items()})}, path)
    assert any(k.startswith("text_audio_encoder.") for k in torch.load(
        path, weights_only=True)["state_dict"])
    full = Convofusion(cfg, device="cpu", seed=22)
    ck.load_torch_full_model(path, full)
    stage1 = Convofusion(cfg, device="cpu", seed=23, stage="vae")
    ck.load_torch_vae(path, stage1)
    for model in (full, stage1):
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), k
    plain = Convofusion(C.TINY, device="cpu", seed=24)
    with pytest.raises(KeyError, match="does not fit the model"):
        ck.load_torch_full_model(path, plain)


ABLATION_YAML = {
    "TRAIN": {"ABLATION": {"MLP_DIST": True}},
    "model": {"motion_vae": {"params": {"normalize_before": False,
                                        "position_embedding": "learned"}},
              "denoiser": {"params": {"position_embedding": "learned"}}},
}


def test_an_ablation_config_through_the_clis(tmp_path):
    root = str(tmp_path)
    beat, dnd = build_fixture(root)
    cfg1, assets1 = write_cfg(root, beat, dnd, "abl_vae", stage="vae",
                              epochs=1, batch=8, lr=1e-3, infer_steps=3,
                              extra=ABLATION_YAML)
    vae = cli_train.main(["--cfg", cfg1, "--cfg_assets", assets1,
                          "--device", "cpu"])
    assert vae.vae.mlp_dist and vae.cfg["motion_vae"]["position_embedding"] \
        == "learned"
    ckpts = os.path.join(root, "experiments", "convofusion")
    vae_ckpt = os.path.join(ckpts, "abl_vae", "checkpoints", "epoch=0.ckpt")
    extra = copy.deepcopy(ABLATION_YAML)
    extra["TRAIN"]["PRETRAINED_VAE"] = vae_ckpt
    cfg2, assets2 = write_cfg(root, beat, dnd, "abl_diff", stage="diffusion",
                              epochs=1, batch=8, lr=1e-3, infer_steps=3,
                              extra=extra)
    argv = ["--cfg", cfg2, "--cfg_assets", assets2, "--device", "cpu"]
    diff = cli_train.main(argv)
    # the stage-1 VAE went in, frozen, and came out in the stage-2 file
    stage1 = torch.load(vae_ckpt, weights_only=True)["state_dict"]
    for k in ("vae.body_dist_layer.weight", "vae.query_pos_encoder.pe"):
        assert torch.equal(diff.state_dict()[k], stage1[k])
    diff_ckpt = os.path.join(ckpts, "abl_diff", "checkpoints",
                             "epoch=0.ckpt")
    run = cli_test.main(argv + [f"TEST.CHECKPOINTS={diff_ckpt}",
                                "TPU.PALLAS_STEP=false"])
    preds = [np.load(os.path.join(d, "pred.npy"))
             for d, _, files in os.walk(run.out_dir) if "pred.npy" in files]
    assert len(preds) == 8
    for p in preds:
        assert p.shape == (128, 63, 3) and np.isfinite(p).all()

    merged = C.load_config(cfg2, assets2, phase="test",
                           overrides=["TPU.PALLAS_STEP=false",
                                      "SERVE.BATCH_SIZE=2"])
    svc = build_service(merged, device="cpu", checkpoint=diff_ckpt)
    try:
        assert not svc.model.uses_step_kernel()
        motion = svc.generate(GestureRequest(text_lsn="a nod"), timeout=120)
        assert motion.shape == (128, 189) and np.isfinite(motion).all()
    finally:
        svc.close()


def test_get_model_dispatch():
    cfg = C.tiny_config("vae")
    model = get_model(cfg, datamodule="dm", device="cpu")
    assert model.stage == "vae" and model.datamodule == "dm"
    cfg.model.model_type = "temos"
    with pytest.raises(ValueError, match="Invalid model type temos"):
        get_model(cfg, device="cpu")


def test_masks():
    mask = lengths_to_mask(torch.tensor([3, 0, 5]), 5)
    assert mask.tolist() == [[True] * 3 + [False] * 2, [False] * 5,
                             [True] * 5]
    out = remove_padding([torch.arange(5), np.arange(5) * 2], [2, 4])
    assert [o.tolist() for o in out] == [[0, 1], [0, 2, 4, 6]]
