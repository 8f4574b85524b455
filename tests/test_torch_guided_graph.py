"""The guided denoiser replayed from CUDA graphs (``models/denoiser.py``:
``GuidedGraph``, ``GuidedGraphs``).

On the CPU every guided call falls back to ``Denoiser.guided`` itself.  The
cache's keys, the static buffers' data flow and the reverse loop's use of
the graphs' outputs are held here with the capture replaced by a stand-in
that records each capture and, at each replay, reruns the captured call
and writes its results into the first call's outputs, as a graph's replay
rewrites its own tensors.  The tests marked ``cuda`` compare graphed with
eager sampling on a card and skip without one; run them there with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_guided_graph.py -q`` (the suite's conftest imports JAX,
which a CUDA installation of the port need not have).
"""
import contextlib
import copy
import sys
import threading
import types

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models import denoiser as denoiser_mod
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.utils import cuda_graphs, profiling

STEPS = 4
KEYS = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
        "active_passive_lsn", "lsn_id")
COUNTERS = ("denoiser.graph_captures", "denoiser.graph_replays",
            "denoiser.graph_eager")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes on one intra-op thread: beside the other test workers,
    OpenMP teams as wide as the machine wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ddim(cfg, steps=STEPS):
    cfg = copy.deepcopy(cfg)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=steps)
    return cfg


def _model(device="cpu", dtype="float32", seed=0):
    return Convofusion(_ddim(TINY), dtype=dtype, device=device, seed=seed)


class Counts:
    """The graph counters' change since it was made."""

    def __init__(self):
        self.before = {k: profiling.COUNTS[k] for k in COUNTERS}

    def __call__(self):
        return {k.split(".")[1]: profiling.COUNTS[k] - self.before[k]
                for k in COUNTERS}


def stand_in(captures):
    """A ``GuidedGraphs._capture`` for the CPU: records the capture, runs
    the call once for its outputs and reruns it at each replay, writing the
    results into those outputs."""

    def capture(self, fn, device):
        captures.append(device)
        out = fn()

        def replay():
            noise7, att = fn()
            out[0].copy_(noise7)
            for s, a in att.items():
                out[1][s].copy_(a)

        return types.SimpleNamespace(replay=replay), out

    return capture


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """Capture allowed on the CPU through the stand-in; yields the list of
    captures."""
    captures = []
    monkeypatch.setattr(cuda_graphs, "CAPTURE_DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(denoiser_mod.GuidedGraphs, "_capture",
                        stand_in(captures))
    return captures


@pytest.fixture(scope="module")
def cpu_model():
    m = _model()
    batch, _, _ = prepare_arrays(m, synthetic_raw_batch(0, 3))
    return m, batch


def _conditions(m, batch):
    cond, masks = m.encode_conditions(*(batch[k] for k in KEYS))
    unc, umasks = m.encode_uncond(batch)
    return cond, unc, masks, umasks


def _latents(m, b, seed=1):
    gen = torch.Generator(device=m.device).manual_seed(seed)
    return torch.randn((b, m.latent_tokens, m.latent_dim), generator=gen,
                       device=m.device)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@torch.no_grad()
def test_cpu_runs_guided_itself_and_counts_it(cpu_model):
    m, batch = cpu_model
    conds = _conditions(m, batch)
    lat = _latents(m, 3)
    counts = Counts()
    with m.guided_graphs.bound(m.denoiser, m.weights_version, lat,
                               *conds) as run:
        got = [run(lat, t) for t in (900, 500)]
    want = [m.denoiser.guided(lat, t, *conds) for t in (900, 500)]
    assert _equal(got, want)
    assert counts() == {"graph_captures": 0, "graph_replays": 0,
                        "graph_eager": 2}


def _variant(m, batch, change):
    """(latents, conditions, keywords of ``bound``) of one guided call,
    with ``change`` applied."""
    cond, unc, masks, umasks = _conditions(m, batch)
    lat = _latents(m, batch["lsn_ids"].shape[0])
    kw = {}
    if change == "batch":
        cond = {s: v[:2] for s, v in cond.items()}
        masks = {s: v[:2] for s, v in masks.items()}
        lat = lat[:2]
    elif change == "text_length":
        cond = dict(cond, tlsn=cond["tlsn"][:, :8])
        masks = dict(masks, tlsn=masks["tlsn"][:, :8])
        unc = dict(unc, tlsn=unc["tlsn"][:, :8])
        umasks = dict(umasks, tlsn=umasks["tlsn"][:, :8])
    elif change == "dtype":
        cond = {s: v.bfloat16() for s, v in cond.items()}
        unc = {s: v.bfloat16() for s, v in unc.items()}
    elif change == "kvs":
        kw["kvs"] = m.denoiser.precompute_step_kv(700, cond, unc)
    elif change == "placed":
        kw["placed"] = True
    return lat, (cond, unc, masks, umasks), kw


@pytest.mark.parametrize("change, captures, eager", [
    ("same", 1, 0),
    ("batch", 2, 0),
    ("text_length", 2, 0),
    ("dtype", 2, 0),
    ("weights_version", 2, 0),
    ("training", 1, 1),
    ("grad", 1, 1),
    ("kvs", 1, 1),
    ("placed", 1, 1),
])
def test_cache_key(cpu_model, graphs_on_cpu, change, captures, eager):
    """A second guided call at the same geometry replays the first's
    graph; another batch, text length, dtype or weights version captures
    anew; training mode, grad, ``kvs`` and a tensor-parallel placement run
    eagerly.  Each call's outputs are ``Denoiser.guided``'s."""
    m, batch = cpu_model
    m.guided_graphs = denoiser_mod.GuidedGraphs()
    counts = Counts()
    with torch.no_grad():
        lat, conds, _ = _variant(m, batch, "same")
        with m.guided_graphs.bound(m.denoiser, m.weights_version, lat,
                                   *conds) as run:
            assert _equal(run(lat, 700), m.denoiser.guided(lat, 700, *conds))
        lat, conds, kw = _variant(m, batch, change)
    version = m.weights_version + (change == "weights_version")
    try:
        m.denoiser.train(change == "training")
        with torch.set_grad_enabled(change == "grad"):
            with m.guided_graphs.bound(m.denoiser, version, lat, *conds,
                                       **kw) as run:
                got = run(lat, 700)
            want = m.denoiser.guided(lat, 700, *conds, kvs=kw.get("kvs"))
    finally:
        m.denoiser.eval()
    assert _equal(got, want)
    assert len(graphs_on_cpu) == captures
    assert counts() == {"graph_captures": captures,
                        "graph_replays": 2 - eager, "graph_eager": eager}


@torch.no_grad()
def test_least_recently_used_geometry_goes_first(cpu_model, graphs_on_cpu,
                                                 monkeypatch):
    m, batch = cpu_model
    monkeypatch.setattr(denoiser_mod, "GRAPH_CACHE_SIZE", 2)
    m.guided_graphs = denoiser_mod.GuidedGraphs()
    order = ("same", "batch", "same", "text_length", "same", "batch")
    for change in order:
        lat, conds, _ = _variant(m, batch, change)
        with m.guided_graphs.bound(m.denoiser, m.weights_version, lat,
                                   *conds) as run:
            run(lat, 300)
    # 'batch' was evicted by 'text_length', 'same' never
    assert len(graphs_on_cpu) == 4


def _reverse(m, batch, capture_attention, seed=3):
    b = batch["lsn_ids"].shape[0]
    init = _latents(m, b, seed)
    steps = torch.randn((STEPS,) + tuple(init.shape),
                        generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        return m.diffusion_reverse(*_by_reverse_order(_conditions(m, batch)),
                                   b, init_noise=init, step_noise=steps,
                                   capture_attention=capture_attention)


def _by_reverse_order(conds):
    cond, unc, masks, umasks = conds
    return cond, masks, unc, umasks


class DirectCalls:
    """The reverse loop as it was before the graphs: every step calls
    ``Denoiser.guided`` itself."""

    @staticmethod
    def bound(denoiser, weights_version, latents, cond_real, cond_unc,
              masks_real=None, masks_unc=None, **_):
        return contextlib.nullcontext(lambda lat, t: denoiser.guided(
            lat, t, cond_real, cond_unc, masks_real, masks_unc))


@pytest.mark.parametrize("capture_attention", ["none", "all"])
def test_diffusion_reverse_bit_equal_on_cpu(cpu_model, monkeypatch,
                                            capture_attention):
    """The loop's result with direct calls, with the eager fallback and
    with the stand-in graphs is one; every step's attention maps are kept,
    not the last replay's."""
    m, batch = cpu_model
    m.guided_graphs = DirectCalls()
    want = _reverse(m, batch, capture_attention)
    m.guided_graphs = denoiser_mod.GuidedGraphs()
    counts = Counts()
    eager = _reverse(m, batch, capture_attention)
    assert counts()["graph_eager"] == STEPS
    captures = []
    monkeypatch.setattr(cuda_graphs, "CAPTURE_DEVICES", ("cpu",))
    monkeypatch.setattr(denoiser_mod.GuidedGraphs, "_capture",
                        stand_in(captures))
    counts = Counts()
    graphed = _reverse(m, batch, capture_attention)
    assert counts() == {"graph_captures": 1, "graph_replays": STEPS,
                        "graph_eager": 0}
    assert _equal(eager, want) and _equal(graphed, want)
    if capture_attention == "all":
        att = graphed[1]["tlsn"]
        assert att.shape[0] == STEPS
        assert not torch.equal(att[0], att[-1])


def test_a_second_thread_runs_eagerly_meanwhile(cpu_model, graphs_on_cpu):
    """Threads sampling one model at two geometries at once: one loop at a
    time holds the graphs, the others run eagerly, and every result is the
    eager one."""
    m, batch = cpu_model
    small = {k: v[:2] for k, v in batch.items()}

    def sample(b):
        return m.sample(b, torch.Generator().manual_seed(7),
                        num_inference_steps=2)

    m.guided_graphs = DirectCalls()
    want = {3: sample(batch), 2: sample(small)}
    m.guided_graphs = denoiser_mod.GuidedGraphs()
    results, errors = [], []

    def worker(i):
        try:
            for _ in range(3):
                b = batch if i % 2 else small
                results.append((b["lsn_ids"].shape[0], sample(b)))
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(results) == 18
    assert all(_equal(out, want[b]) for b, out in results)


def test_moving_the_model_bumps_weights_version():
    m = _model()
    version = m.weights_version
    m.float()
    assert m.weights_version == version + 1


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture there only")
    return torch.device("cuda")


@pytest.fixture
def eager(monkeypatch):
    """Within ``with eager():`` no call is captured."""

    @contextlib.contextmanager
    def off():
        with monkeypatch.context() as mp:
            mp.setattr(cuda_graphs, "CAPTURE_DEVICES", ())
            yield

    return off


def _card_batch(m, b, seed=0):
    batch, _, _ = prepare_arrays(m, synthetic_raw_batch(seed, b))
    return batch


def _noise(m, b, steps=STEPS, seed=5):
    gen = torch.Generator(device=m.device).manual_seed(seed)
    shape = (b, m.latent_tokens, m.latent_dim)
    return (torch.randn(shape, generator=gen, device=m.device),
            torch.randn((steps,) + shape, generator=gen, device=m.device))


def _sample(m, batch, **kw):
    init, steps = _noise(m, batch["lsn_ids"].shape[0])
    return m.sample(batch, init_noise=init, step_noise=steps, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [2, 32])
def test_card_graphed_equals_eager(card, eager, dtype, b):
    m = _model(card, dtype)
    batch = _card_batch(m, b)
    with eager():
        want = _sample(m, batch)
        want_rev = _reverse(m, batch, "none")
    counts = Counts()
    got = _sample(m, batch)
    got_rev = _reverse(m, batch, "none")
    assert counts() == {"graph_captures": 1, "graph_replays": 2 * STEPS,
                        "graph_eager": 0}
    assert _equal(got, want) and _equal(got_rev, want_rev)


@pytest.mark.cuda
def test_card_attention_of_every_step_is_kept(card, eager):
    m = _model(card)
    batch = _card_batch(m, 4)
    with eager():
        want = _sample(m, batch, capture_attention="all")
    got = _sample(m, batch, capture_attention="all")
    assert _equal(got, want)
    att = got[2]["tlsn"]
    assert att.shape[0] == STEPS and not torch.equal(att[0], att[-1])


@pytest.mark.cuda
def test_card_weg(card, eager):
    m = _model(card)
    batch = _card_batch(m, 2)
    focus = {"focus_idx": np.array([[1, 2], [1, 0]], np.int32),
             "focus_valid": np.array([[True, True], [True, False]])}
    wp = {"thresholds": {0: 0.99}, "max_refinement_steps": 2}
    out = {}
    for name, mode in (("eager", eager()),
                       ("graphed", contextlib.nullcontext())):
        m.weg_counts = type(m.weg_counts)()
        with mode:
            out[name] = (_sample(m, batch, focus=focus, weg_params=wp),
                         m.weg_counts)
    assert out["graphed"][1] == out["eager"][1]
    assert out["graphed"][1].refinement_iterations == 2
    assert _equal(out["graphed"][0], out["eager"][0])


@pytest.mark.cuda
def test_card_preseq_window(card, eager):
    m = _model(card)
    batch = _card_batch(m, 4)
    _, prev = _sample(m, batch)
    with eager():
        want = _sample(m, batch, preseq=prev[:, 8:])
    assert _equal(_sample(m, batch, preseq=prev[:, 8:]), want)


@pytest.mark.cuda
def test_card_after_load_state_dict(card, eager):
    m = _model(card)
    batch = _card_batch(m, 4)
    before = _sample(m, batch)
    m.load_state_dict(_model(card, seed=1).state_dict())
    counts = Counts()
    got = _sample(m, batch)
    assert counts()["graph_captures"] == 1
    with eager():
        want = _sample(m, batch)
    assert _equal(got, want) and not _equal(got, before)


@pytest.mark.cuda
def test_card_two_geometries_interleaved(card, eager):
    m = _model(card)
    batches = {b: _card_batch(m, b, seed=b) for b in (2, 3)}
    with eager():
        want = {b: _sample(m, x) for b, x in batches.items()}
    counts = Counts()
    for b in (2, 3, 2, 3):
        assert _equal(_sample(m, batches[b]), want[b])
    assert counts() == {"graph_captures": 2, "graph_replays": 4 * STEPS,
                        "graph_eager": 0}
