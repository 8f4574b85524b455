"""The training step replayed from two CUDA graphs
(``train/step_graphs.py``) and AdamW's device-scalar form
(``train/trainer.py``).

- ``AdamW.step`` with the learning rate and the bias corrections in 0-dim
  tensors filled each step gives the bits of ``AdamW.update``'s host
  numbers, over 5 steps, with and without the clip, in the cosine
  schedule's warm-up and decay.
- On the CPU a ``Trainer`` step is eager, counts ``train.graph_eager``
  twice (``compute_grads`` and ``apply_grads``) and gives the bits of the
  step as written before the graphs.
- The cache, the static buffers' data flow and the fallbacks are held on
  the CPU with the capture replaced by a stand-in: a capture runs the body
  once, which stands for the capture and its first replay; each later
  replay reruns it and writes its results into the first run's outputs,
  as a graph's replay rewrites its own tensors.
- The tests marked ``cuda`` compare graphed with eager steps on a card
  (and count the AdamW kernel's launches: one an eager step, none a
  replay; the optimizer graph's replay is that one kernel) and skip
  without one; run them there with ``python -m pytest --noconftest -p
  no:cacheprovider -m cuda tests/test_torch_train_graph.py -q``.
"""
import contextlib
import copy
import types

import pytest
import torch
import torch.distributed as dist

from convofusion_tpu_torch.config import TINY, TINY_VAE
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion, to_tensors
from convofusion_tpu_torch.train.trainer import AdamW, Trainer
from convofusion_tpu_torch.utils import cuda_graphs, profiling

STEPS = 4
B = 3
COUNTERS = ("train.graph_captures", "train.graph_replays",
            "train.graph_eager")
SHAPES = [(4, 3), (3,), (2, 5, 7)]
SCHEDULES = {
    "constant": {},
    # counts 0-2 ramp up, 3-4 decay
    "cosine_warmup_decay": {"schedule": "cosine", "warmup_steps": 3,
                            "decay_steps": 8, "end_lr_factor": 0.1},
    # decay from the first step to its end, 0, at count 4
    "cosine_decay": {"schedule": "cosine", "decay_steps": 4},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes on one intra-op thread: beside the other test workers,
    OpenMP teams as wide as the machine wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Counts:
    """The step graphs' counters' change since it was made."""

    def __init__(self):
        self.before = {k: profiling.COUNTS[k] for k in COUNTERS}

    def __call__(self):
        return {k.split(".")[1]: profiling.COUNTS[k] - self.before[k]
                for k in COUNTERS}


# ------------------------------------------------------------- the optimizer

@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_device_scalars_give_the_host_scalars_bits(schedule, clip):
    opt = AdamW({"lr": 1e-3, "weight_decay": 1e-2, "grad_clip": clip,
                 **SCHEDULES[schedule]})
    gen = torch.Generator().manual_seed(0)
    start = [torch.randn(s, generator=gen) for s in SHAPES]
    host, dev = [p.clone() for p in start], [p.clone() for p in start]
    host_state, dev_state = opt.init(host), opt.init(dev)
    scalars = [torch.zeros(()) for _ in range(3)]
    lrs = []
    for i in range(5):
        # scales from 0.01 to 100: the clip both keeps and scales
        grads = [torch.randn(s, generator=gen) * 10.0 ** (i - 2)
                 for s in SHAPES]
        lrs.append(opt.schedule(host_state.count))
        torch._foreach_add_(host, opt.update(grads, host_state, host))
        for t, v in zip(scalars, opt.scalars(dev_state.count)):
            t.fill_(v)
        dev_state.count += 1
        torch._foreach_add_(dev, opt.step(grads, dev_state, dev, scalars))
    assert host_state.count == dev_state.count == 5
    for a, b in zip(host + host_state.mu + host_state.nu,
                    dev + dev_state.mu + dev_state.nu):
        assert torch.equal(a, b)
    if schedule == "cosine_warmup_decay":
        assert lrs[0] < lrs[1] < lrs[2] < lrs[3] and lrs[4] < lrs[3]
    elif schedule == "cosine_decay":
        assert lrs[0] > lrs[1] > lrs[2] > lrs[3] > lrs[4] == 0.0


# ------------------------------------------------------- models and inputs

def _cfg(stage, **denoiser):
    cfg = copy.deepcopy(TINY_VAE if stage == "vae" else TINY)
    for block in ("denoiser", "motion_vae", "audio_encoder"):
        cfg[block]["dropout"] = 0.1
    cfg["denoiser"].update(denoiser)
    return cfg


def _model(stage, device="cpu", dtype="bfloat16", **denoiser):
    return Convofusion(_cfg(stage, **denoiser), dtype=dtype, device=device,
                       seed=0, stage=stage)


def _batches(m, n=2):
    out = []
    for i in range(n):
        raw = synthetic_raw_batch(10 + i, B)
        if m.stage == "vae":
            out.append(to_tensors({"motion": raw["motion_lsn"]}, m.device))
        else:
            out.append(prepare_arrays(m, raw)[0])
    return out


def _draws(m, step):
    """Stage 2's draws on the model's device, or None (the loss draws
    from the step's generator)."""
    if m.stage == "vae":
        return None
    gen = torch.Generator(device=m.device).manual_seed(100 + step)
    lat = m.latent_dim
    return {"eps": torch.randn((2, B, 8, lat), generator=gen,
                               device=m.device),
            "group": torch.randint(0, 7, (B,), generator=gen,
                                   device=m.device),
            "noise": torch.randn((B, m.latent_tokens, lat), generator=gen,
                                 device=m.device),
            "timesteps": torch.randint(0, 1000, (B,), generator=gen,
                                       device=m.device)}


def _steps(trainer, batches, draws, seed=7, n=STEPS):
    """``n`` steps from a mask generator seeded ``seed``: each step's
    loss, terms and gradients, then the masters, moments and weights."""
    gen = torch.Generator(device=trainer.model.device).manual_seed(seed)
    out = {"loss": [], "terms": [], "grads": []}
    with trainer.training():
        for i in range(n):
            loss, terms = trainer.compute_grads(
                batches[i % len(batches)], gen, draws[i % len(draws)])
            out["grads"].append([None if p.grad is None else p.grad.clone()
                                 for p in trainer.params])
            trainer.apply_grads()
            out["loss"].append(loss)
            out["terms"].append(terms)
    out["state"] = (trainer.masters + trainer.state.mu + trainer.state.nu
                    + [p.detach() for p in trainer.params])
    out["gen"] = gen.get_state()
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b)


def _before_graphs_step(trainer, batch, gen, draws):
    """One step as the trainer took it before the graphs: the loss and its
    backward, then ``AdamW.update`` with host numbers."""
    loss, terms = trainer.loss_fn()(batch, gen, draws)
    loss.backward()
    grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
             for p, m in zip(trainer.params, trainer.masters)]
    with torch.no_grad():
        torch._foreach_add_(trainer.masters, trainer.optimizer.update(
            grads, trainer.state, trainer.masters))
        lowp = [(p, m) for p, m in zip(trainer.params, trainer.masters)
                if p.dtype != torch.float32]
        torch._foreach_copy_([p for p, _ in lowp], [m for _, m in lowp])
    for p in trainer.params:
        p.grad = None
    return loss.detach()


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_cpu_step_is_eager_and_as_before(stage):
    m = _model(stage)
    batches = _batches(m)
    draws = [_draws(m, i) for i in range(2)]
    counts = Counts()
    trainer = Trainer(m)
    trainer.init_state()
    got = _steps(trainer, batches, draws, n=3)
    assert counts() == {"graph_captures": 0, "graph_replays": 0,
                        "graph_eager": 6}
    assert len(trainer.graphs) == 0

    ref = _model(stage)
    before = Trainer(ref)
    before.init_state()
    gen = torch.Generator().manual_seed(7)
    want = []
    with before.training():
        for i in range(3):
            want.append(_before_graphs_step(before, batches[i % 2], gen,
                                            draws[i % 2]))
    assert _equal(got["loss"], want)
    assert _equal(got["state"], before.masters + before.state.mu
                  + before.state.nu + [p.detach() for p in before.params])
    assert torch.equal(got["gen"], gen.get_state())


# ------------------------------------------- the graphs with a CPU stand-in

def _copy_out(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_out(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_out(d, s)
    elif dst is not None:
        dst.copy_(src)


def stand_in(captures):
    """``GraphPool.run`` and ``GraphPool.capture`` for the CPU (module
    docstring); ``captures`` gets each capture's generators."""

    def run(self, fn, device):
        return fn()

    def capture(self, fn, device, warmup=True, generators=()):
        captures.append(tuple(generators))
        out = fn()
        ran = {"first": True}

        def replay():
            if not ran.pop("first", False):
                _copy_out(out, fn())

        return types.SimpleNamespace(replay=replay), out

    return run, capture


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """Capture allowed on the CPU through the stand-in; yields the list of
    captures."""
    captures = []
    run, capture = stand_in(captures)
    monkeypatch.setattr(cuda_graphs, "CAPTURE_DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(cuda_graphs.GraphPool, "run", run)
    monkeypatch.setattr(cuda_graphs.GraphPool, "capture", capture)
    return captures


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_stand_in_graphs_give_the_eager_bits(graphs_on_cpu, stage):
    m = _model(stage)
    batches = _batches(m)
    draws = [_draws(m, i) for i in range(2)]
    state = copy.deepcopy(m.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_graphs, "CAPTURE_DEVICES", ())
        eager = Trainer(m)
        eager.init_state()
        want = _steps(eager, batches, draws)
    m.load_state_dict(state)
    counts = Counts()
    trainer = Trainer(m)
    trainer.init_state()
    got = _steps(trainer, batches, draws)
    # one capture pair, then three replays of each graph
    assert counts() == {"graph_captures": 2, "graph_replays": 6,
                        "graph_eager": 0}
    assert len(graphs_on_cpu) == 2 and len(graphs_on_cpu[0]) == 1
    for key in ("loss", "terms", "grads", "state", "gen"):
        assert _equal(got[key], want[key]), key
    # fresh tensors: a later replay does not overwrite an earlier loss
    assert len({id(x) for x in got["loss"]}) == STEPS


def test_cache_keys_and_init_state_drop(graphs_on_cpu):
    m = _model("vae", dtype="float32")
    trainer = Trainer(m)
    trainer.init_state()
    small = to_tensors({"motion": synthetic_raw_batch(1, 2)["motion_lsn"]},
                       m.device)
    batch = _batches(m, 1)[0]
    gen, other = torch.Generator(), torch.Generator()
    with trainer.training():
        for b, g in ((batch, gen), (batch, gen), (small, gen),
                     (batch, other), (batch, gen)):
            trainer.compute_grads(b, g)
            trainer.apply_grads()
    # (batch, gen) warmed and captured, small and other one warm-up each
    assert len(trainer.graphs) == 3
    assert len(graphs_on_cpu) == 2
    trainer.init_state()
    assert len(trainer.graphs) == 0
    # the trainer's state in place: load_state_dict keeps them
    with trainer.training():
        trainer.compute_grads(batch, gen)
        trainer.apply_grads()
    trainer.load_state_dict(trainer.state_dict())
    assert len(trainer.graphs) == 1


def test_fallbacks_run_eagerly(graphs_on_cpu, tmp_path):
    """Remat, host-array draws, pending gradients and a data-parallel
    group: eager, counted, nothing cached."""
    gen = torch.Generator().manual_seed(0)

    def eager_steps(trainer, batch, draws=None, twice=False):
        counts = Counts()
        with trainer.training():
            trainer.compute_grads(batch, gen, draws)
            if twice:
                trainer.compute_grads(batch, gen, draws)
            trainer.apply_grads()
        return counts()["graph_eager"]

    m = _model("diffusion", dtype="float32", remat=True)
    trainer = Trainer(m)
    trainer.init_state()
    assert trainer.remat
    assert eager_steps(trainer, _batches(m, 1)[0]) == 2
    assert len(trainer.graphs) == 0

    m = _model("diffusion", dtype="float32")
    trainer = Trainer(m)
    trainer.init_state()
    batch = _batches(m, 1)[0]
    host = {k: v.numpy() for k, v in _draws(m, 0).items()}
    assert eager_steps(trainer, batch, host) == 2
    assert len(trainer.graphs) == 0
    # the second compute_grads finds the first's gradients
    assert eager_steps(trainer, batch, twice=True) == 2
    assert len(trainer.graphs) == 1

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        trainer = Trainer(m)
        trainer.init_state()
        assert eager_steps(trainer, batch) == 2
        assert len(trainer.graphs) == 0
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture there only")
    return torch.device("cuda")


@contextlib.contextmanager
def _eager():
    devices = cuda_graphs.CAPTURE_DEVICES
    cuda_graphs.CAPTURE_DEVICES = ()
    try:
        yield
    finally:
        cuda_graphs.CAPTURE_DEVICES = devices


@pytest.mark.cuda
@pytest.mark.parametrize("with_draws", [False, True])
@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_card_graphed_equals_eager(card, stage, with_draws):
    m = _model(stage, card)
    batches = _batches(m)
    draws = [_draws(m, i) if with_draws else None for i in range(2)]
    state = copy.deepcopy(m.state_dict())
    launches = profiling.COUNTS["adamw.launches"]
    with _eager():
        eager = Trainer(m)
        eager.init_state()
        want = _steps(eager, batches, draws)
    assert profiling.COUNTS["adamw.launches"] - launches == STEPS
    m.load_state_dict(state)
    counts = Counts()
    launches = profiling.COUNTS["adamw.launches"]
    trainer = Trainer(m)
    trainer.init_state()
    got = _steps(trainer, batches, draws)
    assert counts() == {"graph_captures": 2, "graph_replays": 6,
                        "graph_eager": 0}
    # the warm-up step's launch and the capture's
    assert profiling.COUNTS["adamw.launches"] - launches == 2
    for key in ("loss", "terms", "grads", "state", "gen"):
        assert _equal(got[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_card_optimizer_graph_is_one_kernel(card, stage):
    """In a replayed step, the device kernels of ``apply_grads``' span are
    the AdamW kernel and the three fills of the step's scalars."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m = _model(stage, card)
    batches = _batches(m, 1)
    trainer = Trainer(m)
    trainer.init_state()
    gen = torch.Generator(device=card).manual_seed(7)
    with trainer.training():
        # a warm-up step and a capture, then replays under the profiler
        # until it catches their device ranges (it drops a window's now
        # and then)
        for i in range(5):
            if i < 2:
                trainer.compute_grads(batches[0], gen, _draws(m, 0))
                trainer.apply_grads()
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trainer.compute_grads(batches[0], gen, _draws(m, 0))
                trainer.apply_grads()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            ranges = [e.time_range for e in events if e.is_user_annotation
                      and e.name == "train.optimizer"]
            if ranges:
                break
    names = [e.name for e in events if not e.is_user_annotation
             and ranges[0].start <= e.time_range.start < ranges[0].end]
    ours = [n for n in names if "adamw_kernel" in n]
    assert len(ours) == 1, names
    assert all("fill" in n.lower() for n in names if n not in ours), names


@pytest.mark.cuda
def test_card_remat_and_data_parallel_run_eagerly(card, tmp_path):
    m = _model("diffusion", card, remat=True)
    batch = _batches(m, 1)
    counts = Counts()
    trainer = Trainer(m)
    trainer.init_state()
    _steps(trainer, batch, [None], n=2)
    assert counts() == {"graph_captures": 0, "graph_replays": 0,
                        "graph_eager": 4}
    m = _model("diffusion", card)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        counts = Counts()
        trainer = Trainer(m)
        trainer.init_state()
        _steps(trainer, batch, [None], n=2)
        assert counts() == {"graph_captures": 0, "graph_replays": 0,
                            "graph_eager": 4}
    finally:
        dist.destroy_process_group()
