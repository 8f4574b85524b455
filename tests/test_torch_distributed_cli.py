"""The train and test CLIs under ``TPU.MULTIHOST: true``: 2 gloo processes
on the CPU at the tiny geometry, fp32 (``tests/torch_distributed_worker.py
cli``), against the data loader and a 1-process run.

- ``cli/train`` stage 1: each rank's batches are its ``shard=(rank, 2)``
  stride of the epoch, and the strides together are the epoch; both ranks
  take the same steps and end with bit-identical weights; only rank 0
  saved checkpoints and ``metrics.jsonl`` has one row an epoch, with the
  validation terms averaged over the ranks; a resume
  from ``epoch=0.ckpt`` gives the straight 2-epoch run's weights bit-equal.
- ``cli/test``: rank 0 alone writes, and its files are byte-equal to a
  1-process run's; ``cli/unbounded``: both ranks roll out the same
  windows, and one dump directory is written.
- A SIGTERM to rank 1 alone: both ranks stop after the same step, exit 0,
  and one checkpoint is written.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.cli import test as cli_test
from convofusion_tpu_torch.config import parse_args
from convofusion_tpu_torch.data.datamodule import get_datasets
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from test_torch_distributed import free_port, run_ranks
from test_torch_test_cli import _write_cfg
from torch_distributed_worker import TEST_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_cli"))
    beat, dnd = make_fixture_pair(root, n_files=1)
    for name, stage in (("dp_straight", "vae"), ("dp_resumed", "vae"),
                        ("dp_test", "diffusion"), ("dp_roll", "diffusion"),
                        ("dp_sigterm", "vae")):
        _write_cfg(root, beat, dnd, stage, name)
    return root


def _argv(root, name):
    return ["--cfg", os.path.join(root, f"cfg_{name}.yaml"), "--cfg_assets",
            os.path.join(root, f"assets_{name}.yaml"), f"NAME={name}"]


def _exp(root, name):
    return os.path.join(root, "experiments", "convofusion", name)


def _files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


def test_train_and_test_clis_under_two_ranks(tree, tmp_path):
    run_ranks("cli", tmp_path, tree)
    rec = [json.load(open(tmp_path / f"cli_rank{r}.json")) for r in (0, 1)]
    w = [np.load(tmp_path / f"cli_rank{r}.npz") for r in (0, 1)]

    # the straight run's first epoch: rank r's batches are its stride
    cfg = parse_args("train", _argv(tree, "dp_straight")
                     + ["TRAIN.BATCH_SIZE=2"])
    dm = get_datasets(cfg)[0]
    n_items = len(dm.dataset("train"))
    strides = []
    for r in (0, 1):
        loader = dm.train_dataloader(seed=0, shard=(r, 2))
        want = [[str(n) for n in b["name"]] for b in loader]
        got = rec[r]["items"][:len(want)]
        assert got == want, r
        strides.append(set(loader._indices()))
    assert strides[0] | strides[1] == set(range(n_items))
    assert len(strides[0]) == len(strides[1])

    for r in (0, 1):
        assert rec[r]["start_epochs"] == [0, 0, 1]
    assert rec[0]["steps"] == rec[1]["steps"]
    assert all(s > 0 for run in rec[0]["steps"] for s in run)
    # rank 0 alone writes: 2 + 1 + 1 checkpoints, one metrics row an epoch
    assert (rec[0]["saves"], rec[1]["saves"]) == (4, 0)
    with open(os.path.join(_exp(tree, "dp_straight"), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    # the validation terms, averaged over the ranks, and the train terms
    assert all(np.isfinite(r["total/val"]) and np.isfinite(r["total/train"])
               for r in rows)
    # identical replicas; the resume equals the straight run
    for k in w[0].files:
        np.testing.assert_array_equal(w[0][k], w[1][k], err_msg=k)
        if k.startswith("straight/"):
            np.testing.assert_array_equal(
                w[0][k], w[0]["resumed/" + k[len("straight/"):]], err_msg=k)

    # the test CLI: rank 0's files byte-equal to one process's
    assert rec[0]["result_writes"] > 0 and rec[1]["result_writes"] == 0
    one = cli_test.main(_argv(tree, "dp_test") + TEST_OVERRIDES
                        + ["NAME=dp_test_one", "--device", "cpu"])
    two = rec[0]["test_out"]
    assert _files(two) == _files(one.out_dir) != []
    for rel in _files(two):
        with open(os.path.join(two, rel), "rb") as a, \
                open(os.path.join(one.out_dir, rel), "rb") as b:
            assert a.read() == b.read(), rel

    # the rollout CLI: the same windows on both ranks, one dump
    rolls = [k for k in w[0].files if k.startswith("roll/")]
    assert len(rolls) == 3 and rolls == [k for k in w[1].files
                                         if k.startswith("roll/")]
    for k in rolls:
        np.testing.assert_array_equal(w[0][k], w[1][k], err_msg=k)
    dumps = glob.glob(os.path.join(tree, "results", "*", "dp_roll", "*"))
    assert len(dumps) == 1 and _files(dumps[0])


def test_sigterm_on_one_rank_stops_both(tree, tmp_path):
    port = free_port()
    argv = _argv(tree, "dp_sigterm") + [
        "TRAIN.BATCH_SIZE=2", "TRAIN.END_EPOCH=100000",
        "LOGGER.SACE_CHECKPOINT_EPOCH=1000", "TPU.MULTIHOST=true",
        "--device", "cpu"]
    procs, logs = [], []
    try:
        for r in (0, 1):
            env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                       RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            logs.append(open(tmp_path / f"rank{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "convofusion_tpu_torch.cli.train",
                 *argv], cwd=REPO, env=env, stderr=logs[r],
                stdout=subprocess.DEVNULL, text=True))
        deadline = 240
        while deadline > 0:
            logs[0].seek(0)
            if "epoch 0: loss=" in logs[0].read():
                procs[1].send_signal(signal.SIGTERM)
                break
            assert procs[0].poll() is None, "rank 0 ended early"
            deadline -= 0.2
            time.sleep(0.2)
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    assert rcs == [0, 0], texts[0][-2000:] + texts[1][-2000:]
    stops = [[line.split("preemption signal ")[1] for line in t.splitlines()
              if "preemption signal" in line] for t in texts]
    assert len(stops[0]) == 1 and stops[0] == stops[1], stops
    assert len(glob.glob(os.path.join(_exp(tree, "dp_sigterm"),
                                      "checkpoints", "epoch=*.ckpt"))) == 1
