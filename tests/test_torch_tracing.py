"""The port's spans and counters (``convofusion_tpu_torch/utils/profiling.py``)
on the CPU at the tiny geometry: the shared no-op while nothing records,
the sampling call's and the training step's spans and their parents, the
spans as nested ``user_annotation`` events of a ``torch.profiler`` trace,
that recording leaves the sample unchanged, the service's queue wait, and
the counters and spans under threads."""
import contextlib
import copy
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.serving import GestureRequest, GestureService
from convofusion_tpu_torch.train.trainer import Trainer
from convofusion_tpu_torch.utils import profiling

WAIT = 120          # seconds, any single blocking wait
LABEL = "pb_window"


def _ddim(cfg, **dropout):
    cfg = copy.deepcopy(cfg)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=2)
    for block, p in dropout.items():
        cfg[block]["dropout"] = p
    return cfg


@pytest.fixture(scope="module")
def sampler_model():
    m = Convofusion(_ddim(TINY), device="cpu", seed=0)
    batch, _, _ = prepare_arrays(m, synthetic_raw_batch(0, 2))
    return m, batch


def _sample(m, batch):
    return m.sample(batch, torch.Generator().manual_seed(0),
                    num_inference_steps=2)


def _names(spans):
    return Counter(s.name for s in spans)


def test_span_is_one_shared_noop_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("a", i=0), profiling.span("b")
    assert a is b
    with a:
        pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass


def test_sample_spans_nest_under_the_call(sampler_model):
    m, batch = sampler_model
    with profiling.recording() as rec:
        motion, _ = _sample(m, batch)
    assert torch.isfinite(motion).all()
    by = {s.name: s for s in rec.spans}
    top = by["sample"]
    assert top.parent is None and top.attrs == {"rows": 2}
    steps = rec.named("reverse_step")
    assert [s.attrs["i"] for s in steps] == [0, 1]
    assert all(s.parent is by["diffusion_reverse"] for s in steps)
    assert by["diffusion_reverse"].parent is top
    for name in ("denoiser", "step_update"):
        assert [s.parent for s in rec.named(name)] == steps
    assert by["vae.decode"].parent is top
    encs = rec.named("encode_conditions")
    assert [e.parent for e in encs] == [top, top]
    assert [s.parent for s in rec.named("t5.encode")] == \
        [encs[0], encs[0], encs[1], encs[1]]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    assert "weg.refine" not in by
    # the uncond rows are encoded inside the call here: a second
    # encode_conditions, and two more T5 passes
    assert _names(rec.spans) == Counter({
        "sample": 1, "encode_conditions": 2, "t5.encode": 4,
        "diffusion_reverse": 1, "reverse_step": 2, "denoiser": 2,
        "step_update": 2, "vae.decode": 1})


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("recorded", [False, True])
def test_profiler_trace_holds_the_spans(sampler_model, tmp_path, recorded):
    """Under the profiler each span is a ``user_annotation`` on the trace's
    clock, recording or not, nested as the spans are."""
    m, batch = sampler_model
    with profiling.recording() if recorded else \
            contextlib.nullcontext() as rec, profile(
                activities=[ProfilerActivity.CPU]) as prof:
        with record_function(LABEL):
            _sample(m, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    notes = [e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"] != LABEL]
    got = Counter(e["name"] for e in notes)
    assert got == Counter({
        "sample": 1, "encode_conditions": 2, "t5.encode": 4,
        "diffusion_reverse": 1, "reverse_step": 2, "denoiser": 2,
        "step_update": 2, "vae.decode": 1})
    if recorded:
        assert got == _names(rec.spans)
    by = {e["name"]: e for e in notes}
    steps = sorted((e for e in notes if e["name"] == "reverse_step"),
                   key=lambda e: e["ts"])
    assert _inside(by["diffusion_reverse"], by["sample"])
    assert _inside(by["vae.decode"], by["sample"])
    assert all(_inside(s, by["diffusion_reverse"]) for s in steps)
    for name in ("denoiser", "step_update"):
        inner = sorted((e for e in notes if e["name"] == name),
                       key=lambda e: e["ts"])
        assert all(_inside(e, s) for e, s in zip(inner, steps))
    encs = [e for e in notes if e["name"] == "encode_conditions"]
    for e in notes:
        if e["name"] == "t5.encode":
            assert any(_inside(e, enc) for enc in encs)


def test_recording_leaves_the_sample_unchanged(sampler_model):
    m, batch = sampler_model
    plain, _ = _sample(m, batch)
    with profiling.recording():
        recorded, _ = _sample(m, batch)
    assert torch.equal(plain, recorded)


def _train_batch(m, stage):
    raw = synthetic_raw_batch(3, 2)
    if stage == "vae":
        return {"motion": torch.as_tensor(raw["motion_lsn"],
                                          dtype=torch.float32)}
    return prepare_arrays(m, raw)[0]


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_training_step_spans(stage):
    cfg = TINY_VAE if stage == "vae" else TINY
    cfg = _ddim(cfg, denoiser=0.1, motion_vae=0.1, text_encoder=0.1)
    m = Convofusion(cfg, device="cpu", seed=0, stage=stage)
    batch = _train_batch(m, stage)
    trainer = Trainer(m)
    with profiling.recording() as rec:
        loss, _ = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    by = {s.name: s for s in rec.spans}
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert len(rec.named(name)) == 1 and by[name].parent is None
    forward, backward = by["train.forward"], by["train.backward"]
    assert forward.end_ns <= backward.start_ns
    assert backward.end_ns <= by["train.optimizer"].start_ns
    if stage == "diffusion":
        enc = by["encode_conditions"]
        assert enc.parent is by["train.forward"]
        assert [s.parent for s in rec.named("t5.encode")] == [enc, enc]


def test_service_stats_give_the_queue_wait():
    m = Convofusion(_ddim(TINY), device="cpu", seed=0)
    svc = GestureService(m, batch_size=2, num_inference_steps=2,
                         max_wait_ms=200.0)
    try:
        futs = [svc.submit(GestureRequest(text_lsn=f"a nod {i}"))
                for i in range(3)]
        for f in futs:
            assert f.result(timeout=WAIT).shape == (128, 189)
        st = svc.stats()
        svc.reset_stats()
        assert np.isnan(svc.stats()["queue_wait_ms_p95"])
    finally:
        svc.close()
    assert st["requests"] == 3
    # the wait is a part of the latency
    assert 0 <= st["queue_wait_ms_p50"] <= st["queue_wait_ms_p95"]
    assert st["queue_wait_ms_p50"] < st["latency_p50_ms"]
    assert st["queue_wait_ms_p95"] < st["latency_p95_ms"]


def test_counts_and_spans_under_threads():
    """More threads than cores, a short switch interval: no count is lost
    and each span's parent is its own thread's."""
    n_threads, n = 16, 500
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(timeout=WAIT)
        for _ in range(n):
            with profiling.span("outer", thread=k):
                profiling.count("tracing_test.hits")
                with profiling.span("inner", thread=k):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts["tracing_test.hits"] == n_threads * n
    inner = rec.named("inner")
    assert len(inner) == n_threads * n
    for s in inner:
        assert s.parent.name == "outer"
        assert s.parent.attrs == s.attrs and s.parent.thread == s.thread
    assert all(s.parent is None for s in rec.named("outer"))
    assert np.all([s.end_ns >= s.start_ns for s in rec.spans])
