"""The port's training CLI (``cli/train.py``) on fixture trees at the tiny
geometry, fp32, on the CPU.

- One stage-1 epoch of JAX's ``cli.train.main`` and the port's from JAX's
  initial weights (``init_params`` of the CLI's ``k_init``) with JAX's
  per-step keys replayed into the port (``split(PRNGKey(SEED_VALUE))``,
  then a split a step, ``train_vae_loss``'s own split): the epoch's terms
  in ``metrics.jsonl`` within 1e-5 relative, and every final weight within
  1e-5.  The rows whose gradient is 0 in exact arithmetic
  (``zero_gradient_rows``) are held to AdamW's bound instead: its
  m / sqrt(v) turns the rounding of a zero gradient into a step of +-lr
  (observed: a Q/K row of a VAE decoder's cross-attention 5.4e-5 off).
  The weights and draws go in through the module's
  ``build_model`` and ``step_draws``, monkeypatched.
- Stage 2 through the CLI against ``Trainer.fit_steps`` over the batches
  and draws the CLI prepared, with the caches on and off: bit-equal on the
  CPU.
- The trunk and posterior caches against JAX's ``encode_text_trunk`` /
  ``encode_vae_posterior`` on weights carried by ``compat/from_jax``
  (within 1e-5), and the posterior cache in eval mode while a training
  step has the model in train mode.
- Resume, the VAE transplant, SIGTERM in a subprocess, TPU.MULTIHOST.
"""
import glob
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from convofusion_tpu.cli.train import main as jax_main
from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.cli import train as cli_train
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.train import checkpoint as ck
from convofusion_tpu_torch.train.trainer import Trainer
from test_torch_test_cli import _write_cfg
from test_torch_train import vae_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234                     # base.yaml SEED_VALUE
TERM_RTOL, WEIGHT_ATOL = 1e-5, 1e-5
CACHE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    beat, dnd = make_fixture_pair(root, n_files=1)
    return root, beat, dnd


def _argv(workdir, stage, name, *extra):
    root, beat, dnd = workdir
    cfg, assets = _write_cfg(root, beat, dnd, stage, name)
    return ["--cfg", cfg, "--cfg_assets", assets, f"NAME={name}", *extra]


def _exp(workdir, name):
    return os.path.join(workdir[0], "experiments", "convofusion", name)


def _metrics(workdir, name):
    with open(os.path.join(_exp(workdir, name), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_stage1_epoch_matches_jax_cli(workdir, monkeypatch):
    over = ("TRAIN.BATCH_SIZE=2", "TRAIN.END_EPOCH=1")
    params_j = jax_main(_argv(workdir, "vae", "s1_jax", *over))

    jm = JaxConvofusion(tiny_config("vae"))
    _, k_init = jax.random.split(jax.random.PRNGKey(SEED))
    init = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init_params(k_init)))

    def build_model(cfg, dtype, device):
        from convofusion_tpu_torch.config import from_cfg

        assert dtype == "float32"
        m = Convofusion(from_cfg(cfg), device=device, seed=None, stage="vae")
        m.load_state_dict(init)
        return m

    keys = [jax.random.split(jax.random.PRNGKey(SEED))[0]]

    def step_draws(model, b, nframes, gen):
        keys[0], k = jax.random.split(keys[0])
        return {"eps": torch.from_numpy(vae_draws(k, b)["eps"])}

    monkeypatch.setattr(cli_train, "build_model", build_model)
    monkeypatch.setattr(cli_train, "step_draws", step_draws)
    port = cli_train.main(_argv(workdir, "vae", "s1_port", *over,
                                "--device", "cpu"))
    (row_j,), (row_p,) = _metrics(workdir, "s1_jax"), _metrics(workdir,
                                                               "s1_port")
    terms = {k for k in row_j if k.endswith("/train")}
    assert terms == {k for k in row_p if k.endswith("/train")}
    assert {"total/train", "recons/feature/train", "kl/motion/train",
            "recons/laplace/train"} <= terms
    for k in terms:
        assert abs(row_p[k] - row_j[k]) <= TERM_RTOL * abs(row_j[k]), k
    assert port.train_stats.epochs[0]["steps"] == 7
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    got = port.state_dict()
    assert set(got) == set(want)
    lr, steps = 1e-4, 7                      # config_vae_beatdnd.yaml LR
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        zero = zero_gradient_rows(name, w)
        if zero is not None:
            # exact gradient 0: AdamW turns the rounding into +-lr a step
            # on either side, so these rows only stay within its bound
            assert np.abs(g[zero] - w[zero]).max() <= 2 * lr * steps, name
            g, w = np.delete(g, zero, axis=0), np.delete(w, zero, axis=0)
        gap = np.abs(g - w).max()
        assert gap <= WEIGHT_ATOL, (name, gap)
    ckpt = os.path.join(_exp(workdir, "s1_port"), "checkpoints",
                        "epoch=0.ckpt")
    assert os.path.isfile(ckpt)


def zero_gradient_rows(name, w):
    """Rows of a packed attention projection whose gradient is 0 in exact
    arithmetic: the key bias of every attention (a constant added to all of
    a query's scores drops out of the softmax), and the query and key
    projections of the VAE decoders' cross-attention, whose memory is the
    one latent token (latent_dim[0] = 1: the softmax over one key is 1)."""
    if not name.endswith(("in_proj_weight", "in_proj_bias")):
        return None
    d = len(w) // 3
    if name.startswith("vae.") and ".multihead_attn." in name:
        return np.s_[:2 * d]
    return np.s_[d:2 * d] if name.endswith("in_proj_bias") else None


def _recording(monkeypatch):
    """Record every (batch, draws) the CLI's steps get and the model it
    built, as it was built."""
    seen = {"steps": [], "init": None}
    compute = Trainer.compute_grads
    build = cli_train.build_model

    def compute_grads(self, batch, generator=None, draws=None):
        seen["steps"].append(({k: v.clone() for k, v in batch.items()},
                              {k: v.clone() for k, v in draws.items()}))
        return compute(self, batch, generator, draws)

    def build_model(cfg, dtype, device):
        m = build(cfg, dtype, device)
        seen["init"] = {k: v.clone() for k, v in m.state_dict().items()}
        seen["cfg"] = m.cfg
        return m

    monkeypatch.setattr(Trainer, "compute_grads", compute_grads)
    monkeypatch.setattr(cli_train, "build_model", build_model)
    return seen


@pytest.mark.parametrize("caches", [True, False], ids=["cached", "ids"])
def test_stage2_cli_equals_fit_steps(workdir, caches, monkeypatch):
    """One stage-2 epoch through the CLI (dropout 0.1 in the mel MLP, the
    masks from the loss generator) against ``fit_steps`` from the same
    initial weights over the batches and draws it prepared: bit-equal."""
    on = "1" if caches else "0"
    seen = _recording(monkeypatch)
    name = f"s2_{'cached' if caches else 'ids'}"
    model = cli_train.main(_argv(
        workdir, "diffusion", name, "TRAIN.BATCH_SIZE=4", "TRAIN.END_EPOCH=1",
        f"TPU.CACHE_TEXT_TRUNK={on}", f"TPU.CACHE_VAE_POSTERIOR={on}",
        "--device", "cpu"))
    monkeypatch.undo()
    batches, draws = zip(*seen["steps"])
    assert len(batches) == model.train_stats.epochs[0]["steps"] == 2
    assert ("lsn_trunk" in batches[0]) == ("vae_mu" in batches[0]) == caches
    assert ("lsn_ids" in batches[0]) != caches
    if caches:
        assert batches[0]["uncond_trunk"].shape[0] == 1
        stats = model.train_stats.epochs[0]
        assert stats["posterior_misses"] == 8 and stats["trunk_misses"] > 0

    fresh = Convofusion(seen["cfg"], device="cpu", seed=None)
    fresh.load_state_dict(seen["init"])
    losses = Trainer(fresh).fit_steps(
        list(batches), torch.Generator().manual_seed(SEED), log_every=1,
        draws=list(draws))
    (row,) = _metrics(workdir, name)
    assert row["total/train"] == pytest.approx(np.mean(losses), rel=1e-6)
    want = fresh.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.fixture(scope="module")
def jax_twins():
    cfg = tiny_config("diffusion")
    jm = JaxConvofusion(cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(5)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def test_caches_match_jax_encoders(jax_twins):
    """The CLI's cached rows (hits and misses, a repeated text encoded
    once, the uncond row at batch 1) against JAX's encoders."""
    jm, params, tm = jax_twins
    raw = jax_synthetic.synthetic_raw_batch(2, 3)
    texts_lsn = list(raw["text_lsn"])
    # a repeat inside the speaker batch, and a speaker text the listener
    # batch repeats
    texts_spk = [texts_lsn[0], raw["text_spk"][1], raw["text_spk"][1]]
    trunk = cli_train.TrunkCache(tm)
    encoded, encode = [], trunk.encode
    trunk.encode = lambda texts: encoded.append(len(texts)) or encode(texts)
    first = trunk.arrays(texts_spk, texts_lsn)
    again = trunk.arrays(texts_spk, texts_lsn)
    # spk: 3 misses, 2 distinct encoded; lsn: 1 hit, 2 misses; uncond: 1
    assert encoded == [2, 2, 1]
    assert (trunk.cache.hits, trunk.cache.misses) == (1 + 7, 6)
    for who, texts in (("spk", texts_spk), ("lsn", texts_lsn),
                       ("uncond", ["-" * 10])):
        tb = jm.tokenize(texts)
        want = np.asarray(jm.encode_text_trunk(
            params, tb.input_ids, tb.attention_mask))
        got = first[f"{who}_trunk"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, rtol=0,
                                   err_msg=who)
        np.testing.assert_array_equal(first[f"{who}_tmask"],
                                      tb.attention_mask)
        np.testing.assert_array_equal(again[f"{who}_trunk"], got)

    motion = np.asarray(raw["motion_lsn"], np.float32)
    post = cli_train.PosteriorCache(tm, cap=5)
    names = ["a", "b", "a"]
    mu, lv = post(names, motion)
    mu_j, lv_j = jm.encode_vae_posterior(params, motion)
    np.testing.assert_allclose(mu, np.asarray(mu_j), atol=CACHE_ATOL, rtol=0)
    np.testing.assert_allclose(lv, np.asarray(lv_j), atol=CACHE_ATOL, rtol=0)
    assert (post.hits, post.misses) == (0, 3)
    mu2, _ = post(names[::-1], motion[::-1].copy())
    np.testing.assert_array_equal(mu2, mu[::-1])
    assert (post.hits, post.misses) == (3, 3) and len(post.cache) == 3
    post(["c"], motion[:1] + 1.0)          # 3 + 1 > cap 5? no: kept
    post(["d", "e"], motion[:2] + 2.0)     # 4 + 2 > 5: cleared first
    assert len(post.cache) == 2


def test_cached_posterior_is_eval_mode_during_a_training_step():
    """VAE dropout 0.1, the model in train mode inside a stage-1 step: the
    cache's encode (the CLI's prefetch thread does it then) equals
    ``encode_vae_posterior`` in eval mode, while the shared VAE in train
    mode would give another posterior."""
    import copy

    from convofusion_tpu_torch.config import TINY_VAE

    cfg = copy.deepcopy(TINY_VAE)
    cfg["motion_vae"]["dropout"] = 0.1
    model = Convofusion(cfg, device="cpu", seed=0, stage="vae")
    motion = torch.from_numpy(np.asarray(
        torch_synthetic.synthetic_raw_batch(3, 4)["motion_lsn"], np.float32))
    want = model.encode_vae_posterior(motion)
    cache = cli_train.PosteriorCache(model)
    trainer = Trainer(model)
    trainer.init_state()
    with trainer.training():
        assert model.training and model.vae.training
        trainer.compute_grads({"motion": motion},
                              torch.Generator().manual_seed(1))
        mu, lv = cache([f"n{i}" for i in range(4)], motion.numpy())
        with torch.no_grad():
            _, (mu_train, _), _ = model.vae.encode(motion)
    assert np.array_equal(mu, want[0].numpy())
    assert np.array_equal(lv, want[1].numpy())
    assert not torch.equal(mu_train.transpose(0, 1), want[0])


def test_resume_and_transplant(workdir):
    """Stage 1 for 2 epochs; stage 2 from its file (PRETRAINED_VAE) for 2
    epochs with validation each; then TRAIN.RESUME starts at epoch 2 from
    epoch=1.ckpt and gives the straight 3-epoch run's weights bit-equal."""
    s1 = cli_train.main(_argv(workdir, "vae", "tr_vae", "TRAIN.BATCH_SIZE=2",
                              "TRAIN.END_EPOCH=2", "--device", "cpu"))
    vae_file = os.path.join(_exp(workdir, "tr_vae"), "checkpoints",
                            "epoch=1.ckpt")
    common = ["TRAIN.BATCH_SIZE=4", f"TRAIN.PRETRAINED_VAE={vae_file}",
              "LOGGER.VAL_EVERY_STEPS=1", "LOGGER.SACE_CHECKPOINT_EPOCH=1",
              "--device", "cpu"]
    two = cli_train.main(_argv(workdir, "diffusion", "tr_a",
                               "TRAIN.END_EPOCH=2", *common))
    vae = {k: v for k, v in s1.state_dict().items()}
    for k, v in two.state_dict().items():
        if k.startswith("vae."):
            assert torch.equal(v, vae[k]), k       # frozen in stage 2
    rows = _metrics(workdir, "tr_a")
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["total/train"]) and np.isfinite(r["total/val"])
               for r in rows)
    resumed = cli_train.main(_argv(workdir, "diffusion", "tr_a",
                                   "TRAIN.END_EPOCH=3", "TRAIN.RESUME=true",
                                   *common))
    assert resumed.train_stats.start_epoch == 2
    assert [e["epoch"] for e in resumed.train_stats.epochs] == [2]
    straight = cli_train.main(_argv(workdir, "diffusion", "tr_b",
                                    "TRAIN.END_EPOCH=3", *common))
    want = straight.state_dict()
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        _exp(workdir, "tr_a"), "checkpoints", "*")))
    assert files == ["epoch=0.ckpt", "epoch=1.ckpt", "epoch=2.ckpt"]


def test_multihost_raises(workdir):
    with pytest.raises(NotImplementedError, match="TPU.MULTIHOST"):
        cli_train.main(_argv(workdir, "vae", "mh", "TPU.MULTIHOST=true",
                             "--device", "cpu"))


def test_sigterm_checkpoints_and_exits(workdir):
    """A SIGTERM after the first epoch: 'preemption signal' logged, the
    partial epoch checkpointed under its number, exit 0."""
    argv = _argv(workdir, "vae", "preempt", "TRAIN.BATCH_SIZE=2",
                 "TRAIN.END_EPOCH=100000", "LOGGER.SACE_CHECKPOINT_EPOCH=1000",
                 "--device", "cpu")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "convofusion_tpu_torch.cli.train", *argv],
        cwd=REPO, env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    log = []
    try:
        for line in proc.stderr:
            log.append(line)
            if "epoch 0: loss=" in line:
                proc.send_signal(signal.SIGTERM)
                break
        log += proc.stderr.readlines()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(log)
    assert rc == 0, text[-2000:]
    assert "preemption signal" in text, text[-2000:]
    ckpts = glob.glob(os.path.join(_exp(workdir, "preempt"), "checkpoints",
                                   "epoch=*.ckpt"))
    assert len(ckpts) == 1
    model = Convofusion(TINY, device="cpu", seed=None, stage="vae")
    ck.load_checkpoint(ckpts[0], model)
