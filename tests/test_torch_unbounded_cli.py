"""The port's long-form rollout CLI (``cli/unbounded.main``) against the JAX
package's ``rollout`` on the same test batch.

A fixture tree at ``MAX_LEN`` 256 gives one test batch of 2 BEAT
recordings of 2 parts (3 windows).  The port's ``main`` runs the tiny
geometry, fp32, DDIM-4 and the config's 'semantic' WEG from a checkpoint
holding JAX's ``init_params`` (T5 trunk included); JAX's ``rollout`` runs
the batch the port's data module built, on those parameters, and its
noise (the rollout's key splits) is replayed into ``main`` through
``window_noise``.  Every window's stitched motion within 1e-4
(tests/test_torch_rollout.py observes ~2e-5 a window), the dump tree's
files equal (texts, wavs, meta byte for byte; ground truth exact).
"""
import os

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.cli import unbounded as jax_unbounded
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.cli import unbounded as cli_unbounded
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY, parse_args
from convofusion_tpu_torch.data.datamodule import get_datasets
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train import checkpoint as ck
from test_torch_rollout import _rollout_noise
from test_torch_test_cli import STEPS, _write_cfg

MOTION_ATOL = 1e-4
B, PARTS, LAT = 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(
                d, f)
    return out


def test_unbounded_main_matches_jax_rollout(tmp_path, monkeypatch):
    root = str(tmp_path)
    beat, dnd = make_fixture_pair(root, n_files=1)
    cfg_path, assets = _write_cfg(root, beat, dnd, "diffusion", "long")
    argv = ["--cfg", cfg_path, "--cfg_assets", assets,
            "DATASET.SAMPLER.MAX_LEN=256", "DATASET.SAMPLER.MIN_LEN=256"]

    jcfg = tiny_config("diffusion")
    jcfg.model.scheduler["variant"] = "ddim"
    jm = JaxConvofusion(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(3)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    ckpt = ck.save_checkpoint(os.path.join(root, "ckpt"), 0, tm,
                              keep_text_model=True)

    # the batch main will roll out: the port's data module, test split
    (batch,) = list(get_datasets(parse_args("test", argv), phase="test")[0]
                    .test_dataloader())
    assert batch["motion_lsn"].shape == (B, PARTS * 128, 189)
    key = jax.random.PRNGKey(9)
    outs_j = jax_unbounded.rollout(
        jm, params, batch, key, num_inference_steps=STEPS,
        weg_type="semantic", save_dir=os.path.join(root, "jax"),
        verbose=False)

    calls = []

    def window_noise(model, b, num_steps, n_windows, gen):
        calls.append((b, num_steps, n_windows))
        return _rollout_noise(key, n_windows, num_steps, (b, 16, LAT))

    monkeypatch.setattr(cli_unbounded, "window_noise", window_noise)
    run = cli_unbounded.main(argv + [f"TEST.CHECKPOINTS={ckpt}",
                                     "--device", "cpu"])
    assert calls == [(B, STEPS, 3)] and run.batch_sizes == [B]
    assert run.weg_counts.text_only_passes >= STEPS
    (outs_t,) = run.windows
    assert len(outs_t) == len(outs_j) == 3
    for o_t, o_j in zip(outs_t, outs_j):
        assert o_t.shape == (B, 128, 189) and np.isfinite(o_t).all()
        np.testing.assert_allclose(o_t, np.asarray(o_j), rtol=0,
                                   atol=MOTION_ATOL)

    assert os.path.basename(run.out_dir).startswith("unbounded_")
    tree_j, tree_t = _tree(os.path.join(root, "jax")), _tree(run.out_dir)
    assert sorted(tree_t) == sorted(tree_j) and len(tree_t) > 3 * B
    focus = []
    for rel, pj in tree_j.items():
        pt = tree_t[rel]
        if rel.endswith(".npy"):
            a, b = np.load(pj), np.load(pt)
            if rel.endswith("pred.npy"):
                np.testing.assert_allclose(b, a, rtol=0, atol=MOTION_ATOL,
                                           err_msg=rel)
            else:
                np.testing.assert_array_equal(b, a, err_msg=rel)
        else:
            with open(pj, "rb") as f1, open(pt, "rb") as f2:
                text = f1.read()
                assert text == f2.read(), rel
            if rel.endswith("focus_words_lsn.txt"):
                focus.append(text)
    # the semantic WEG picked words in some window
    assert any(focus)
