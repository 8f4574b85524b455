"""Checkpoints of the PyTorch port, held to the JAX package's loaders.

- A port checkpoint read by JAX's ``load_torch_full_model`` /
  ``load_torch_vae`` gives a tree whose leaves equal, bit for bit, the JAX
  tree the port's weights convert to (the JAX package's own converters,
  as ``test_torch_train.jax_params_from_port``), in fp32 and from a bf16
  model.
- A JAX tree carried into the port, saved and loaded, comes back bit-equal.
- Files hold no T5 trunk unless asked; a load keeps the live trunk.
- ``latest_checkpoint``, ``transplant_vae`` (VAE only), the T5 asset drop,
  background saves, and resume: N steps + save + load + M steps give the
  losses of N + M straight steps bit for bit on the CPU, with dropout 0.1
  drawn from the step generator.
No JAX function is compiled: the JAX side converts and compares trees.
"""
import copy
import os
import warnings

import numpy as np
import pytest
import torch

from convofusion_tpu.train import checkpoint as jax_ckpt
from convofusion_tpu_torch.compat.from_jax import (
    _flatten,
    state_dict_from_jax,
)
from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train import checkpoint as ck
from convofusion_tpu_torch.train.trainer import Trainer
from convofusion_tpu_torch.utils import assets
from test_torch_train import jax_params_from_port

B = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tiny shapes on one intra-op thread: beside the other
    test workers, OpenMP teams as wide as the machine wait on each other,
    and these steps took ~50x longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_tree(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_weights(a, b, skip=None):
    sb = b.state_dict()
    for k, v in a.state_dict().items():
        if skip is None or not k.startswith(skip):
            assert torch.equal(v, sb[k]), k


def _zero_all_but_trunk(model):
    with torch.no_grad():
        for n, p in model.named_parameters():
            if not n.startswith(ck.TRUNK):
                p.zero_()


def dropout_config(stage="diffusion"):
    """TINY (TINY_VAE) with dropout 0.1 in the denoiser and the VAE too."""
    cfg = copy.deepcopy(TINY_VAE if stage == "vae" else TINY)
    cfg["denoiser"]["dropout"] = 0.1
    cfg["motion_vae"]["dropout"] = 0.1
    return cfg


@pytest.fixture(scope="module")
def batch():
    raw = synthetic_raw_batch(0, B)
    model = Convofusion(TINY, device="cpu", seed=0)
    return {"diffusion": prepare_arrays(model, raw)[0],
            "vae": {"motion": torch.from_numpy(raw["motion_lsn"])}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_reads_a_port_checkpoint(tmp_path, dtype):
    model = Convofusion(TINY, dtype=dtype, device="cpu", seed=3)
    want = jax_params_from_port(model)
    path = ck.save_checkpoint(str(tmp_path), 7, model)
    assert os.path.basename(path) == "epoch=7.ckpt"
    # the file has no trunk: JAX keeps the one of the tree it is given
    got = jax_ckpt.load_torch_full_model(path, want)
    _assert_same_tree(got, want)
    vae = jax_ckpt.load_torch_vae(path)
    _assert_same_tree(vae, want["vae"])


def test_jax_reads_a_port_stage1_checkpoint(tmp_path):
    model = Convofusion(TINY_VAE, device="cpu", seed=4, stage="vae")
    path = ck.save_checkpoint(str(tmp_path), 1, model)
    _assert_same_tree(jax_ckpt.load_torch_vae(path),
                      jax_params_from_port(model)["vae"])


def test_jax_tree_round_trips_through_a_checkpoint(tmp_path):
    tree = jax_params_from_port(Convofusion(TINY, device="cpu", seed=5))
    model = Convofusion(TINY, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(tree))
    path = ck.save_checkpoint(str(tmp_path), 2, model, keep_text_model=True)
    back = Convofusion(TINY, device="cpu", seed=None)
    ck.load_checkpoint(path, back)
    _assert_same_weights(back, model)
    _assert_same_tree(jax_params_from_port(back), tree)


def test_files_hold_no_trunk_and_load_keeps_the_live_one(tmp_path):
    model = Convofusion(TINY, device="cpu", seed=6)
    path = ck.save_checkpoint(str(tmp_path), 1, model)
    sd = torch.load(path, weights_only=True)["state_dict"]
    assert not [k for k in sd if "text_model" in k]
    # the reference's names for the two encoders
    assert any(k.startswith("text_audio_encoder.text_encoder.projection")
               for k in sd)
    assert any(k.startswith("text_audio_encoder.audio_encoder.main")
               for k in sd)
    assert not [k for k in sd if k.startswith(("text_encoder.",
                                               "audio_encoder."))]
    other = Convofusion(TINY, device="cpu", seed=7)
    live = {k: v.clone() for k, v in other.state_dict().items()
            if k.startswith(ck.TRUNK)}
    ck.load_checkpoint(path, other)
    _assert_same_weights(other, model, skip=ck.TRUNK)
    for k, v in live.items():
        assert torch.equal(other.state_dict()[k], v), k
    kept = ck.save_checkpoint(str(tmp_path), 2, model, keep_text_model=True)
    ck.load_checkpoint(kept, other)
    _assert_same_weights(other, model)


def test_bf16_checkpoint_is_fp32_and_loads_bit_equal(tmp_path):
    model = Convofusion(TINY, dtype="bfloat16", device="cpu", seed=8)
    path = ck.save_checkpoint(str(tmp_path), 1, model)
    sd = torch.load(path, weights_only=True)["state_dict"]
    assert {v.dtype for v in sd.values()} == {torch.float32}
    fresh = Convofusion(TINY, dtype="bfloat16", device="cpu", seed=8)
    _zero_all_but_trunk(fresh)
    ck.load_checkpoint(path, fresh)
    _assert_same_weights(fresh, model)


def test_latest_checkpoint_picks_the_highest_epoch(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "absent")) is None
    for name in ("epoch=2.ckpt", "epoch=10.ckpt", "epoch=9.ckpt",
                 "epoch=11.ckpt.tmp", "last.ckpt"):
        (tmp_path / name).write_bytes(b"")
    # a write still in progress (.tmp) is not a checkpoint
    assert ck.latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "epoch=10.ckpt")


def test_transplant_vae_moves_only_the_vae(tmp_path):
    stage1 = Convofusion(TINY_VAE, device="cpu", seed=9, stage="vae")
    path = ck.save_checkpoint(str(tmp_path), 5, stage1)
    stage2 = Convofusion(TINY, device="cpu", seed=10)
    before = {k: v.clone() for k, v in stage2.state_dict().items()}
    ck.transplant_vae(stage2, path)
    got = stage2.state_dict()
    for k, v in got.items():
        if k.startswith("vae."):
            assert torch.equal(v, stage1.state_dict()[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert not torch.equal(got["vae.body_final_layer.weight"],
                           before["vae.body_final_layer.weight"])


def test_reference_dims_are_checked(tmp_path):
    model = Convofusion(TINY, device="cpu", seed=11)
    path = ck.save_checkpoint(str(tmp_path), 1, model)
    wider = copy.deepcopy(TINY)
    wider["denoiser"]["num_layers"] = 2
    with pytest.raises(ValueError, match="denoiser_layers"):
        ck.load_torch_full_model(path, Convofusion(wider, device="cpu"))
    vae_cfg = copy.deepcopy(TINY_VAE)
    vae_cfg["latent_dim"] = [1, 16]
    with pytest.raises(ValueError, match="latent_dim"):
        ck.load_torch_vae(path, Convofusion(vae_cfg, device="cpu",
                                            stage="vae"))


def _hf_t5_file(path, model, shared_only=True):
    """The model's trunk under HF T5 names, as pytorch_model.bin holds it
    (``shared.weight`` in place of the encoder's tied embedding)."""
    trunk = {k[len(ck.TRUNK):]: v.clone()
             for k, v in model.state_dict().items()
             if k.startswith(ck.TRUNK)}
    if shared_only:
        trunk["shared.weight"] = trunk.pop("encoder.embed_tokens.weight")
    torch.save(trunk, path)


def test_t5_asset_drop(tmp_path, monkeypatch):
    monkeypatch.setenv(assets.ENV_VAR, str(tmp_path))
    model = Convofusion(TINY, device="cpu", seed=12)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not ck.maybe_load_t5_assets(model)        # nothing dropped
    _assert_same_weights(model, Convofusion(TINY, device="cpu", seed=12))
    (tmp_path / "t5-base").mkdir()
    source = Convofusion(TINY, device="cpu", seed=13)
    _hf_t5_file(tmp_path / "t5-base" / "pytorch_model.bin", source)
    assert ck.maybe_load_t5_assets(model)
    for k, v in model.state_dict().items():
        want = source.state_dict()[k] if k.startswith(ck.TRUNK) else before[k]
        assert torch.equal(v, want), k
    # another geometry warns and changes nothing
    big = copy.deepcopy(TINY)
    big["text_encoder"]["vocab_size"] = 1200
    other = Convofusion(big, device="cpu", seed=14)
    with pytest.warns(UserWarning, match="skipping injection"):
        assert not ck.maybe_load_t5_assets(other)
    assert not ck.maybe_load_t5_assets(
        Convofusion(TINY_VAE, device="cpu", stage="vae"))


def test_background_save_reads_back_equal(tmp_path):
    model = Convofusion(TINY, device="cpu", seed=15)
    path = ck.save_checkpoint(str(tmp_path), 3, model, background=True)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():            # the host copy was taken at the call
        for p in model.parameters():
            p.add_(1.0)
    ck.wait_for_checkpoints()
    fresh = Convofusion(TINY, device="cpu", seed=15)
    _zero_all_but_trunk(fresh)
    ck.load_checkpoint(path, fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k


def _fit(model, trainer, batch, gen, n):
    return trainer.fit_steps([batch] * n, gen, log_every=1)


@pytest.mark.parametrize("stage,dtype", [("diffusion", "float32"),
                                         ("vae", "float32"),
                                         ("diffusion", "bfloat16")])
def test_resume_equals_straight_steps(tmp_path, batch, stage, dtype):
    """2 steps + save + load into a fresh model, trainer and generator + 2
    steps: the losses of 4 straight steps, bit for bit, with dropout 0.1
    drawn from the step generator (an unrelated torch.manual_seed between
    does not matter)."""
    cfg = dropout_config(stage)
    data = batch[stage]

    def fresh():
        model = Convofusion(cfg, dtype=dtype, device="cpu", seed=16,
                            stage=stage)
        return model, Trainer(model)

    model, trainer = fresh()
    straight = _fit(model, trainer, data, torch.Generator().manual_seed(17),
                    4)
    model, trainer = fresh()
    gen = torch.Generator().manual_seed(17)
    first = _fit(model, trainer, data, gen, 2)
    path = ck.save_checkpoint(str(tmp_path), 2, model, trainer, gen)
    torch.manual_seed(1234)
    model, trainer = fresh()
    gen = torch.Generator()
    ck.load_checkpoint(path, model, trainer, gen)
    assert trainer.state.count == 2
    assert first + _fit(model, trainer, data, gen, 2) == straight


def test_trainer_state_mismatch_resumes_with_params_only(tmp_path, batch):
    model = Convofusion(TINY, device="cpu", seed=18)
    trainer = Trainer(model)
    _fit(model, trainer, batch["diffusion"], torch.Generator(), 1)
    path = ck.save_checkpoint(str(tmp_path), 1, model, trainer)
    # the joint stage also trains the VAE: its trainer has more names
    joint = Convofusion(TINY, device="cpu", seed=19, stage="vae_diffusion")
    joint_trainer = Trainer(joint)
    with pytest.warns(UserWarning, match="params only"):
        ck.load_checkpoint(path, joint, joint_trainer)
    _assert_same_weights(joint, model, skip=ck.TRUNK)
    assert joint_trainer.state.count == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = Trainer(Convofusion(TINY, device="cpu", seed=20))
        ck.load_checkpoint(path, again.model, again)
    assert again.state.count == 1


def test_params_only_resume_takes_fp32_masters_from_the_file(tmp_path):
    """A bf16 trainer resumed from a file without trainer state starts its
    fp32 masters from the file's fp32 weights, not from their bf16
    rounding (JAX trains on the fp32 values it loads)."""
    src = Convofusion(TINY, device="cpu", seed=21)
    path = ck.save_checkpoint(str(tmp_path), 0, src)
    model = Convofusion(TINY, dtype="bfloat16", device="cpu", seed=None)
    trainer = Trainer(model)
    with pytest.warns(UserWarning, match="params only"):
        ck.load_checkpoint(path, model, trainer)
    want = dict(src.named_parameters())
    got = dict(model.named_parameters())
    rounded = 0
    for n, master in zip(trainer.names, trainer.masters):
        assert master.dtype == torch.float32
        assert torch.equal(master, want[n].detach()), n
        assert torch.equal(got[n], master.to(got[n].dtype)), n
        rounded += int(not torch.equal(got[n].float(), master))
    assert rounded > 0
