"""The port's test CLI against the JAX package's, and its attention capture.

Both ``cli.test.main``s run on one on-disk fixture (BEAT + DnD trees from
``data/fixture.py``) at the tiny geometry, fp32, DDIM-4, with
``TEST.SAVE_PREDICTIONS`` on and the config's 'semantic' WEG, both loading
one ``.ckpt`` the port writes (JAX's ``load_torch_full_model`` reads a port
file).  Their noise differs (JAX keys against a torch generator), so the
predicted motion is compared by shape and finiteness only; everything the
data pipeline and the tokenizer decide is compared exactly: the result
directory names and files, ground truth, texts, word maps, focus words,
meta, wavs, semantic scores and byte-equal semantic CSVs.

``sample(capture_attention='all')`` is held to JAX's ``att_seq`` on JAX's
weights and replayed noise: every stream within 1e-4.
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from convofusion_tpu.cli.test import main as jax_main
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.cli.test import main as port_main
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import (
    DEFAULTS_DIR,
    TINY,
    from_cfg,
    load_config,
)
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train import checkpoint as ck
from test_torch_sampler import _jax_noise_sequence

STEPS = 4
# attention maps are softmax rows (in [0, 1]) of fp32 denoiser layers:
# one call agrees to ~1e-6; over 4 guided steps the latents drift by up
# to ~5e-5 (test_torch_sampler.py), which moves the weights less
ATT_ATOL = 1e-4
TEXT_FILES = ("lsn_text.txt", "spk_text.txt", "lsn_wordmap.txt",
              "spk_wordmap.txt", "focus_words_lsn.txt", "meta.txt",
              "sem_info_lsn.csv")
EXACT_ARRAYS = ("gt.npy", "spk_motion.npy", "sem_lsn.npy")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes on one intra-op thread (OpenMP teams as wide as the
    machine wait on each other beside the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_MODEL = {
    "latent_dim": [1, 32],
    "motion_vae": {"params": {"num_layers": 3, "ff_size": 64,
                              "dropout": 0.0}},
    "denoiser": {"params": {"num_layers": 3, "ff_size": 64, "dropout": 0.0,
                            "text_encoded_dim": 64,
                            "audio_encoded_dim": 64}},
    "text_encoder": {"params": {"latent_dim": 64, "d_model": 32,
                                "d_ff": 64, "num_layers": 2,
                                "num_heads": 4, "d_kv": 8,
                                "vocab_size": 1000}},
    "audio_encoder": {"params": {"latent_dim": 64}},
    "scheduler": {"variant": "ddim", "num_inference_timesteps": STEPS},
    # a short refinement loop: random weights refine at step 0
    "weg_parameters": {"max_refinement_steps": 3},
}


def _merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            _merge(a[k], v)
        else:
            a[k] = v
    return a


def _write_cfg(root, beat, dnd, stage, name):
    """A tiny experiment yaml on config_cf_beatdnd.yaml ('semantic' WEG),
    and an assets yaml with the data roots and the model geometry: the
    module yamls merge after the experiment file, the assets file last."""
    with open(os.path.join(DEFAULTS_DIR, "config_cf_beatdnd.yaml")) as f:
        cfg = yaml.safe_load(f)
    _merge(cfg, {
        "NAME": name,
        "TRAIN": {"STAGE": stage},
        "TEST": {"BATCH_SIZE": 4, "SAVE_PREDICTIONS": True,
                 "COUNT_TIME": True},
        "TPU": {"TEXT_PAD_LEN": 16, "COMPUTE_DTYPE": "float32"},
    })
    path = os.path.join(root, f"cfg_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(DEFAULTS_DIR, "assets.yaml")) as f:
        assets = yaml.safe_load(f)
    assets["DATASET"]["BEATDND"]["ROOT"] = [beat, dnd]
    assets["DATASET"]["BEATDND"]["SPLIT_ROOT"] = [beat, dnd]
    assets["FOLDER"] = os.path.join(root, "experiments")
    assets["TEST"] = {"FOLDER": os.path.join(root, "results")}
    _merge(assets["model"], TINY_MODEL)
    assets_path = os.path.join(root, f"assets_{name}.yaml")
    with open(assets_path, "w") as f:
        yaml.safe_dump(assets, f)
    return path, assets_path


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("test_cli"))
    beat, dnd = make_fixture_pair(root, n_files=1)
    return root, beat, dnd


def _files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


def _run_both(workdir, stage, name):
    """Both CLIs on one config; for stage 2 both load one port checkpoint
    (the T5 trunk included, so the two trunks agree too).  JAX's CLI reads
    a '.ckpt' as a full model only, so the 'vae' stage runs from each
    side's own initialisation."""
    root, beat, dnd = workdir
    cfg_path, assets_path = _write_cfg(root, beat, dnd, stage, name)
    argv = ["--cfg", cfg_path, "--cfg_assets", assets_path]
    if stage != "vae":
        model = Convofusion(from_cfg(load_config(cfg_path, assets_path)),
                            device="cpu", seed=3, stage=stage)
        ckpt = ck.save_checkpoint(os.path.join(root, name), 0, model,
                                  keep_text_model=True)
        argv.append(f"TEST.CHECKPOINTS={ckpt}")
    jax_dir = jax_main(argv + [f"NAME={name}_jax"])
    run = port_main(argv + ["--device", "cpu", f"NAME={name}_port"])
    return jax_dir, run


def test_test_cli_writes_jax_result_tree(workdir):
    jax_dir, run = _run_both(workdir, "diffusion", "gen")
    files = _files(run.out_dir)
    assert files == _files(jax_dir)
    preds = [f for f in files if f.endswith("pred.npy")]
    assert len(preds) == len(run.sample_ms) * 4 == 8
    assert any(f.endswith("sem_info_lsn.csv") for f in files)
    att = [f for f in files if "/att_tlsn/" in f]
    assert len(att) == 8 * STEPS
    for rel in files:
        a, b = os.path.join(run.out_dir, rel), os.path.join(jax_dir, rel)
        if rel.endswith(TEXT_FILES) or rel.endswith(".wav"):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), rel
        elif rel.endswith(EXACT_ARRAYS):
            np.testing.assert_array_equal(np.load(a), np.load(b),
                                          err_msg=rel)
        elif rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape and np.isfinite(x).all(), rel
    # some rows carried focus words (semantic WEG ran)
    focus = [open(os.path.join(run.out_dir, f)).read() for f in files
             if f.endswith("focus_words_lsn.txt")]
    assert any(focus)
    exp = os.path.join(workdir[0], "experiments", "convofusion", "gen_port")
    assert os.path.isfile(os.path.join(exp, "times.txt"))
    assert len(run.tokenize_ms) == len(run.loader_ms) == 2
    assert run.batch_sizes == [4, 4]


def test_vae_stage_writes_jax_result_tree(workdir):
    jax_dir, run = _run_both(workdir, "vae", "vae")
    files = _files(run.out_dir)
    assert files == _files(jax_dir) and files
    assert {os.path.basename(f) for f in files} == {"gt.npy", "pred.npy"}
    for rel in files:
        x = np.load(os.path.join(run.out_dir, rel))
        y = np.load(os.path.join(jax_dir, rel))
        if rel.endswith("gt.npy"):
            np.testing.assert_array_equal(x, y, err_msg=rel)
        assert x.shape == y.shape == (128, 63, 3) and np.isfinite(x).all()


@pytest.fixture(scope="module")
def twins():
    cfg = tiny_config("diffusion")
    cfg.model.scheduler["variant"] = "ddim"
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def test_captured_attention_matches_jax(twins):
    """Every step's full-condition maps, stream -> (steps, B, layers, Tq,
    Tk), against JAX's att_seq on the same weights and noise; the cached
    sampler returns them too, and 'none' returns what it always did."""
    import dataclasses

    jm, params, tm = twins
    tm.scheduler = dataclasses.replace(tm.scheduler, variant="ddim")
    raw = jax_synthetic.synthetic_raw_batch(4, 2)
    jbatch, _, _ = jax_synthetic.prepare_arrays(jm, raw)
    tbatch, _, _ = torch_synthetic.prepare_arrays(tm, raw)
    key = jax.random.PRNGKey(2)
    motion_j, _, att_j = jax.jit(lambda p, b, k: jm.sample(
        p, b, k, num_inference_steps=STEPS, capture_attention="all"))(
        params, jbatch, key)
    init, steps = _jax_noise_sequence(key, STEPS, (2, 16, 32))
    noise = dict(init_noise=torch.from_numpy(init),
                 step_noise=torch.from_numpy(steps))
    motion, latents, att = tm.sample(tbatch, num_inference_steps=STEPS,
                                     capture_attention="all", **noise)
    assert set(att) == set(att_j) == {"spkemb", "alsn", "tlsn", "apb",
                                      "lsnemb"}
    for s, want in att_j.items():
        want = np.asarray(want)
        assert tuple(att[s].shape) == want.shape and want.shape[:3] == (
            STEPS, 2, 3), s
        np.testing.assert_allclose(att[s].numpy(), want, atol=ATT_ATOL,
                                   rtol=0, err_msg=s)
    np.testing.assert_allclose(motion.numpy(), np.asarray(motion_j),
                               atol=2e-4, rtol=2e-5)
    cached = tm.cached_sampler(STEPS, capture_attention="all")
    _, lat_c, att_c = cached(tbatch, **noise)
    assert torch.equal(lat_c, latents)
    for s in att:
        assert torch.equal(att_c[s], att[s])
    plain = tm.sample(tbatch, num_inference_steps=STEPS, **noise)
    assert len(plain) == 2 and torch.equal(plain[1], latents)
    with pytest.raises(ValueError, match="capture_attention"):
        tm.sample(tbatch, num_inference_steps=STEPS,
                  capture_attention="last", **noise)
