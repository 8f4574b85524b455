"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``, the
Trainer's gradient all-reduce): 2 gloo processes on the CPU at the tiny
geometry, as JAX's ``tests/test_multihost.py`` runs 2 processes.  One card
cannot hold two NCCL ranks, so the two-rank behaviour is proven here.

- Two ranks, each given its half of a global batch with the global draws
  fed, equal one process given the whole batch: the reduced losses within
  1e-6 relative and every weight within 1e-6, at dropout 0.  At dropout 0.1
  (each rank's masks its own stream) the ranks agree on every reduced loss
  and end with bit-identical weights.  With no draws fed, each rank draws
  the global batch's values from the shared generator and keeps its rows:
  again one process's run on the global batch.
- ``init_distributed``'s refusals, and the helpers without a group.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_distributed_worker.py")
sys.path.insert(0, HERE)
import torch_distributed_worker as worker  # noqa: E402

LOSS_RTOL, WEIGHT_ATOL = 1e-6, 1e-6
JOIN_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(scenario, out, *args, world=2, timeout=JOIN_TIMEOUT_S):
    """``world`` worker processes of ``scenario``; each must exit 0 within
    ``timeout`` seconds, else all are killed and the test fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), str(port),
         str(out), *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: a rank did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


def zero_gradient_rows(name, w):
    """Rows of a packed attention projection whose gradient is 0 in exact
    arithmetic (``test_torch_train_cli.zero_gradient_rows``): AdamW's
    m / sqrt(v) turns the rounding of a zero gradient into a step of up to
    lr, so these rows are held to that bound."""
    if not name.endswith(("in_proj_weight", "in_proj_bias")):
        return None
    d = len(w) // 3
    if name.startswith("vae.") and ".multihead_attn." in name:
        return np.s_[:2 * d]
    return np.s_[d:2 * d] if name.endswith("in_proj_bias") else None


def _weights(npz, name):
    prefix = f"{name}/w/"
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def test_two_ranks_equal_one_rank_on_the_global_batch(tmp_path):
    run_ranks("trainer", tmp_path)
    ranks = [np.load(tmp_path / f"trainer_rank{r}.npz") for r in range(2)]
    # one process, the whole batch of 2B, the same global draws
    n = 2 * worker.B
    for name, fn in (("d0", lambda: worker.train_fed(0.0, 0, 1, n)),
                     ("drawn", lambda: worker.train_drawn(0, 1, n))):
        losses, state = fn()
        for got in ranks:
            np.testing.assert_allclose(got[f"{name}/losses"], losses,
                                       rtol=LOSS_RTOL, atol=0)
            w = _weights(got, name)
            assert set(w) == set(state)
            for k, v in state.items():
                g, v = w[k], v.float().numpy()
                zero = zero_gradient_rows(k, v)
                if zero is not None:
                    lr = worker.TINY["train"]["optim"]["lr"]
                    assert np.abs(g[zero] - v[zero]).max() <= \
                        2 * lr * worker.STEPS, k
                    g, v = np.delete(g, zero, axis=0), np.delete(v, zero,
                                                                 axis=0)
                gap = np.abs(g - v).max()
                assert gap <= WEIGHT_ATOL, (name, k, gap)
    # dropout 0.1: the masks differ by rank, every reduced loss and the
    # final weights do not
    np.testing.assert_array_equal(ranks[0]["d1/losses"],
                                  ranks[1]["d1/losses"])
    assert np.isfinite(ranks[0]["d1/losses"]).all()
    w0, w1 = _weights(ranks[0], "d1"), _weights(ranks[1], "d1")
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    assert not np.array_equal(ranks[0]["d1/losses"], ranks[0]["d0/losses"])


@pytest.mark.parametrize("multihost,env,error,match", [
    (True, {}, RuntimeError, "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR"),
    (True, {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}, RuntimeError,
     "MASTER_ADDR, MASTER_PORT"),
    (False, {"WORLD_SIZE": "2"}, ValueError, "TPU.MULTIHOST is off"),
])
def test_init_distributed_refuses(monkeypatch, multihost, env, error, match):
    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error, match=match):
        mesh.init_distributed({"TPU": {"MULTIHOST": multihost}}, "cpu")
    assert not mesh.is_initialized()


def test_card_group_needs_cuda(monkeypatch):
    """Without ``--device cpu`` the group is NCCL on the card; with no card
    it raises rather than falling back to one process."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mesh.init_distributed({"TPU": {"MULTIHOST": True}})
    assert not mesh.is_initialized()


def test_without_a_group_nothing_is_reduced():
    assert not mesh.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    assert mesh.local_data_parallel(96) == (None, 1)
    assert mesh.local_device_count() == 1
    assert mesh.any_rank(True) and not mesh.any_rank(False)
    assert mesh.host_mean({"a": 1.5}) == {"a": 1.5}
    x = torch.arange(6.0).reshape(2, 3)
    (y,) = mesh.all_reduce_mean([x.to(torch.bfloat16)])
    assert y.dtype == torch.float32 and torch.equal(y, x)
    assert mesh.local_rows(x, 1) is x
    gen = torch.Generator().manual_seed(3)
    assert mesh.mask_generator(gen, "cpu") is gen
    mesh.process_barrier("no-op")
    assert mesh.rank_seed(7, 0) == 7 and mesh.rank_seed(7, 1) != 7
    assert mesh.init_distributed({"TPU": {}}, "cpu") == torch.device("cpu")
