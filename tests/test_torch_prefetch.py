"""The training CLI's host helpers against the JAX package's: ``prefetch``
(order, the error's position, early exit, inline depth), the metrics
logger (``loss2logname``, ``aggregate_terms`` with one host copy, a
``metrics.jsonl`` row), the text-embedding cache and the progress line.
"""
import json
import logging
import threading

import numpy as np
import pytest
import torch

from convofusion_tpu.callback import progress as jax_progress
from convofusion_tpu.models import text_cache as jax_text_cache
from convofusion_tpu.train import prefetch as jax_prefetch
from convofusion_tpu.utils import metrics_logger as jax_ml
from convofusion_tpu_torch.callback import progress
from convofusion_tpu_torch.models import text_cache
from convofusion_tpu_torch.train import prefetch as port_prefetch
from convofusion_tpu_torch.utils import metrics_logger as ml

# fp32 terms averaged in float64 on both sides
VALUE_TOL = 1e-7


def _both(fn):
    return fn(jax_prefetch.prefetch), fn(port_prefetch.prefetch)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_order(depth):
    want, got = _both(lambda p: list(p(range(20), lambda x: x * x,
                                       depth=depth)))
    assert got == want == [x * x for x in range(20)]


@pytest.mark.parametrize("where", ["prepare", "iterable"])
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_error_at_its_position(where, depth):
    def items():
        for i in range(10):
            if where == "iterable" and i == 4:
                raise KeyError("bad item")
            yield i

    def prepare(x):
        if where == "prepare" and x == 4:
            raise ValueError("bad batch")
        return x

    def run(p):
        seen = []
        with pytest.raises((KeyError, ValueError)) as e:
            for x in p(items(), prepare, depth=depth):
                seen.append(x)
        return seen, type(e.value)

    want, got = _both(run)
    assert got == want == ([0, 1, 2, 3],
                           ValueError if where == "prepare" else KeyError)


def test_prefetch_early_exit_retires_the_producer():
    """A consumer that breaks leaves no producer running and the source
    not drained past the queue's depth."""
    def run(p):
        pulled = []

        def items():
            for i in range(1000):
                pulled.append(i)
                yield i

        it = p(items(), None, depth=2)
        first = [next(it) for _ in range(3)]
        it.close()
        alive = [t for t in threading.enumerate()
                 if t.name == "convofusion-prefetch"]
        return first, len(pulled) <= 3 + 2 + 1, alive

    (f_j, bounded_j, alive_j), (f_p, bounded_p, alive_p) = _both(run)
    assert f_p == f_j == [0, 1, 2] and bounded_p and bounded_j
    assert alive_p == [] and alive_j == []


def test_prefetch_yields_host_tensors_unchanged_on_the_cpu():
    out = list(port_prefetch.prefetch(
        range(3), lambda i: {"x": torch.full((2,), float(i))}, depth=2,
        device="cpu"))
    assert [float(o["x"][0]) for o in out] == [0.0, 1.0, 2.0]


def _term_dicts(rng, n_steps, with_nan=True):
    keys = ("total", "recons_feature", "kl_motion", "recons_laplace")
    out = []
    for i in range(n_steps):
        d = {k: np.float32(rng.normal() + 3.0) for k in keys}
        if with_nan and i == 2:
            d["kl_motion"] = np.float32("nan")
        out.append(d)
    return out


def test_aggregate_terms_and_log_names_match_jax(tmp_path):
    dicts = _term_dicts(np.random.default_rng(0), 7)
    want = jax_ml.aggregate_terms(dicts, "train")
    tensors = [{k: torch.tensor(v) for k, v in d.items()} for d in dicts]
    for got in (ml.aggregate_terms(dicts, "train"),
                ml.aggregate_terms(tensors, "train")):
        assert list(got) == list(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= VALUE_TOL * abs(v), k
    assert "kl/motion/train" in want and "total/train" in want
    for loss in ("total", "inst_loss", "recons_feature", "kl_motion"):
        assert ml.loss2logname(loss, "val") == jax_ml.loss2logname(loss,
                                                                    "val")
    assert ml.aggregate_terms([], "val") == jax_ml.aggregate_terms([], "val")
    all_nan = [{"total": torch.tensor(float("nan"))}] * 2
    assert np.isnan(ml.aggregate_terms(all_nan, "train")["total/train"])

    rows = []
    for mod in (jax_ml, ml):
        logger = mod.MetricsLogger(str(tmp_path / mod.__name__))
        logger.log(want, step=3)
        logger.log({"epoch_seconds": 1.5}, step=4)
        logger.close()
        with open(logger.path) as f:
            rows.append([json.loads(line) for line in f])
    (j1, j2), (p1, p2) = rows
    for a, b in ((j1, p1), (j2, p2)):
        assert a.keys() == b.keys() and a["step"] == b["step"]
        assert all(a[k] == b[k] for k in a if k != "ts")


def test_aggregate_terms_copies_to_the_host_once(monkeypatch):
    """One device->host copy for the epoch: the stacked terms, not a
    ``float()`` per term per step."""
    tensors = [{k: torch.tensor(v) for k, v in d.items()}
               for d in _term_dicts(np.random.default_rng(1), 5, False)]
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(self.shape)
                        or cpu(self, *a, **k))
    monkeypatch.setattr(torch.Tensor, "__float__", lambda self: pytest.fail(
        "float() of a term"))
    ml.aggregate_terms(tensors, "train")
    assert copies == [(5, 4)]


def test_text_embedding_cache_matches_jax(tmp_path):
    """Hits, misses, the encode calls (a repeated text once) and the
    assembled rows, in memory and through the .npz tier."""
    def encoder(log):
        def encode(texts):
            log.append(list(texts))
            emb = np.stack([np.full((4, 3), float(len(t)), np.float32)
                            for t in texts])
            mask = np.stack([np.arange(4) < min(len(t), 4) for t in texts])
            return emb, mask
        return encode

    batches = [["a", "bb", "a"], ["bb", "ccc"], ["dddd", "a"]]
    results = []
    for mod, name in ((jax_text_cache, "jax"), (text_cache, "port")):
        log = []
        cache = mod.TextEmbeddingCache(str(tmp_path / name),
                                       max_memory_items=2)
        outs = [cache.encode_batch(b, 16, encoder(log)) for b in batches]
        fresh = mod.TextEmbeddingCache(str(tmp_path / name))
        disk = fresh.encode_batch(["ccc", "a"], 16, encoder(log))
        results.append((log, cache.hits, cache.misses, outs, disk,
                        fresh.hits))
    (lj, hj, mj, oj, dj, fj), (lp, hp, mp, op, dp, fp) = results
    assert lp == lj == [["a", "bb"], ["ccc"], ["dddd"]]
    assert (hp, mp, fp) == (hj, mj, fj) == (2, 5, 2)
    for (ej, kj), (ep, kp) in zip(oj + [dj], op + [dp]):
        np.testing.assert_array_equal(ep, ej)
        np.testing.assert_array_equal(kp, kj)


def test_progress_line_matches_jax(caplog, monkeypatch):
    metrics = {"total/train": 1.23456, "total/val": 2.5}
    for mod in (jax_progress, progress):
        monkeypatch.setattr(mod, "host_memory_percent", lambda: 12.34)
    with caplog.at_level(logging.INFO):
        jax_progress.ProgressLogger(logging.getLogger("a")).on_epoch_end(
            3, metrics)
        progress.ProgressLogger(logging.getLogger("b"), {
            "loss": "total/train"}).on_epoch_end(3, metrics)
        progress.ProgressLogger(logging.getLogger("c")).on_epoch_end(
            3, metrics)
    lines = [r.getMessage() for r in caplog.records]
    assert lines[0] == lines[2] == ("Epoch 3   total/train: 1.2346   "
                                    "total/val: 2.5000   RAM: 12.3%")
    assert lines[1] == "Epoch 3   loss: 1.2346   RAM: 12.3%"
    assert 0.0 < progress.host_memory_percent() < 100.0
