"""The AdamW kernel's wrapper and plain version (``ops/adamw.py``).

- ``work_list``: the chunk table covers every element of every
  tensor exactly once, over mixes of bf16 and fp32 tensors, odd sizes,
  misaligned offsets, one-element tensors and absent gradients; vectors
  only where every pointer of a tensor is 16-byte aligned.
- ``_check`` raises on what the kernel does not take.
- ``adamw_reference`` is ``clip_by_global_norm`` and ``adamw_updates``
  plus the masters' add and the bf16 copy, bit for bit, over 4 steps with the clip off, on (its own norm) and
  given a norm, with some gradients absent; ``adamw_step`` on the CPU is
  ``adamw_reference``.
- ``nvcc.start`` compiles in a child process that ``nvcc.build`` waits
  for (a stand-in compiler).
- The tests marked ``cuda`` hold the kernel to the plain version on a card
  (bit-equal: with the clip's own norm, the plain version is given the
  norm the kernel made, ``prepass_norm``) and skip without one; run them
  there with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
  tests/test_torch_adamw.py -q``.
"""
import copy
import sys

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.ops import adamw, nvcc
from convofusion_tpu_torch.train.trainer import AdamW, AdamWState
from convofusion_tpu_torch.utils import profiling

STEPS = 4
LR, WD = 1e-3, 1e-2
# (numel, parameter dtype, gradient absent, element offset into a larger
# buffer): odd sizes around the chunk and the 8-element vector, one-element
# tensors, views that start off 16-byte alignment
MIX = [(1, torch.bfloat16, False, 0), (7, torch.float32, False, 1),
       (8, torch.bfloat16, False, 0), (9, torch.bfloat16, True, 0),
       (512, torch.bfloat16, False, 3), (513, torch.float32, False, 0),
       (1, torch.float32, True, 0), (1000, torch.float32, False, 2),
       (8192, torch.bfloat16, False, 0), (8193, torch.bfloat16, False, 5),
       (3 * 8192 + 5, torch.float32, False, 0),
       (512 * 1024, torch.bfloat16, False, 0)]
CLIPS = {"off": (0.0, False), "own_norm": (0.05, False),
         "given_norm": (0.05, True)}


def _view(n, dtype, offset, device, gen, scale):
    """n random elements of ``dtype`` times ``scale``, ``offset`` elements
    into a larger buffer."""
    buf = (torch.randn(n + offset, generator=gen) * scale).to(device, dtype)
    return buf[offset:]


def _tensors(device="cpu", seed=0, mix=MIX):
    """Parameters (bf16 with an fp32 master, or fp32 as their own master),
    moments, and per step the gradients in the parameter's dtype."""
    gen = torch.Generator().manual_seed(seed)
    weights, masters, grads = [], [], [[] for _ in range(STEPS)]
    for n, dtype, absent, offset in mix:
        p = _view(n, dtype, offset, device, gen, 0.1)
        if dtype == torch.float32:
            weights.append(None)
            masters.append(p)
        else:
            weights.append(p)
            masters.append(p.float())
        for step in grads:
            step.append(None if absent else
                        _view(n, dtype, offset, device, gen,
                              10.0 ** (len(step) % 3 - 1)))
    mu = [torch.zeros_like(m) for m in masters]
    nu = [torch.zeros_like(m) for m in masters]
    return grads, masters, mu, nu, weights


def _scalars(opt, count, device):
    return [torch.tensor(v, dtype=torch.float32, device=device)
            for v in opt.scalars(count)]


def _norm(grads, masters):
    g = [torch.zeros_like(m) if x is None else x.float()
         for x, m in zip(grads, masters)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))


# ------------------------------------------------------------- the work list

def spans(desc, chunks, chunk):
    """What each block of the kernel takes, in block order, as csrc
    ``adamw_kernel`` computes it: (tensor, start, vector end, end)
    elements, [start, vector end) in 8-element vectors and [vector end,
    end) one by one."""
    for t, k in chunks:
        start = int(k) * chunk
        end = min(start + chunk, int(desc[t, 5]))
        vec = start + (end - start) // adamw.VEC * adamw.VEC \
            if desc[t, 6] & adamw.FLAG_ALIGNED else start
        yield int(t), start, vec, end


@pytest.mark.parametrize("chunk", [8, 24, 4096, adamw.CHUNK])
def test_work_list_covers_every_element_once(chunk):
    grads, masters, mu, nu, weights = _tensors()
    desc, chunks = adamw.work_list(grads[0], masters, mu, nu, weights, chunk)
    assert desc.shape == (len(MIX), len(adamw.DESC_FIELDS))
    covered = [np.zeros(m.numel(), np.int64) for m in masters]
    last = {}
    for t, start, vec, end in spans(desc, chunks, chunk):
        assert start < end <= start + chunk
        # a tensor's chunks in order, tensors in order
        assert start == last.get(t, -chunk) + chunk and \
            all(k <= t for k in last)
        last[t] = start
        covered[t][start:end] += 1
    for c in covered:
        assert (c == 1).all()
    for i, (g, m, a, v, w) in enumerate(zip(grads[0], masters, mu, nu,
                                            weights)):
        ptrs = [0 if x is None else x.data_ptr() for x in (g, m, a, v, w)]
        assert list(desc[i, :6]) == ptrs + [m.numel()]
        flags = int(desc[i, 6])
        assert bool(flags & adamw.FLAG_HAS_GRAD) == (g is not None)
        assert bool(flags & adamw.FLAG_GRAD_BF16) == (
            g is not None and g.dtype == torch.bfloat16)
        assert bool(flags & adamw.FLAG_HAS_WEIGHT) == (w is not None)
        assert bool(flags & adamw.FLAG_ALIGNED) == all(
            p % adamw.ALIGN == 0 for p in ptrs)
    # the mix has both kinds, and an aligned tensor takes vectors
    assert {bool(f & adamw.FLAG_ALIGNED) for f in desc[:, 6]} == {True,
                                                                 False}


def test_work_list_rejects_a_chunk_off_the_vector():
    grads, masters, mu, nu, weights = _tensors(mix=MIX[:2])
    for chunk in (0, 12):
        with pytest.raises(ValueError, match="multiple of 8"):
            adamw.work_list(grads[0], masters, mu, nu, weights, chunk)


def test_prepass_norm_is_the_kernels_order():
    """Exact for sums that fp32 holds exactly: the fixed order, not the
    rounding, is the mirror's point (the card compares bits)."""
    partials = torch.arange(adamw.NORM_BLOCKS, dtype=torch.float32)
    want = float(np.sqrt(np.float32(partials.sum().item())))
    assert float(adamw.prepass_norm(partials)) == want
    assert adamw.prepass_norm(torch.zeros(adamw.NORM_BLOCKS)).item() == 0.0


# ------------------------------------------------------------------ checks

def _checked(**change):
    grads, masters, mu, nu, weights = _tensors(mix=MIX[:4])
    args = dict(grads=grads[0], masters=masters, mu=mu, nu=nu,
                weights=weights, scalars=_scalars(AdamW({"lr": LR}), 0,
                                                  "cpu"), norm=None)
    for name, fn in change.items():
        args[name] = fn(args[name])
    adamw._check(**args)


def _at(i, fn):
    """A list with its i-th tensor replaced by fn of it."""
    return lambda ts: [fn(t) if j == i else t for j, t in enumerate(ts)]


@pytest.mark.parametrize("change,error,match", [
    ({"grads": _at(2, lambda t: torch.randn(16).to(t.dtype)[::2])},
     ValueError, "contiguous"),
    ({"mu": _at(3, lambda t: torch.zeros(10))}, ValueError, "shape"),
    ({"grads": _at(0, lambda t: t.half())}, TypeError, "grad is"),
    ({"masters": _at(1, lambda t: t.bfloat16())}, TypeError, "master is"),
    ({"nu": _at(0, lambda t: t.double())}, TypeError, "nu is"),
    ({"weights": _at(0, lambda t: t.float())}, TypeError, "weight is"),
    ({"mu": _at(2, lambda t: None)}, ValueError, "mu is None"),
    ({"nu": lambda ts: ts[:-1]}, ValueError, "length"),
    ({"scalars": lambda s: [1e-3] + s[1:]}, TypeError, "scalars"),
    ({"norm": lambda n: torch.ones(2)}, TypeError, "norm"),
])
def test_checks_raise_on_what_the_kernel_does_not_take(change, error,
                                                       match):
    _checked()
    with pytest.raises(error, match=match):
        _checked(**change)


def test_step_raises_off_cpu_and_cuda():
    _, masters, mu, nu, weights = _tensors(device="meta", mix=MIX[:2])
    with pytest.raises(ValueError, match="cpu or cuda"):
        adamw.adamw_step([None, None], masters, mu, nu, weights, [], WD,
                         0.0)


# ------------------------------------------------------- the plain version

@pytest.mark.parametrize("wd", [0.0, WD])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_reference_is_adamw_step_plus_add_and_copy(clip, wd):
    grad_clip, given = CLIPS[clip]
    opt = AdamW({"lr": LR, "weight_decay": wd, "grad_clip": grad_clip})
    grads, masters, mu, nu, weights = _tensors()
    want = copy.deepcopy((masters, mu, nu, weights))
    state = AdamWState(mu=want[1], nu=want[2])
    launches = profiling.COUNTS["adamw.launches"]
    for step in range(STEPS):
        norm = _norm(grads[step], masters) if given else None
        scalars = _scalars(opt, step, "cpu")
        adamw.adamw_step(grads[step], masters, mu, nu, weights, scalars,
                         wd, grad_clip, norm)
        fp32 = [torch.zeros_like(m) if g is None else g.float()
                for g, m in zip(grads[step], want[0])]
        torch._foreach_add_(want[0], adamw.adamw_updates(
            adamw.clip_by_global_norm(fp32, grad_clip, norm), state.mu,
            state.nu, want[0], scalars, wd))
        for w, m in zip(want[3], want[0]):
            if w is not None:
                w.copy_(m)
    for a, b in zip(masters + mu + nu + weights,
                    want[0] + want[1] + want[2] + want[3]):
        assert (a is None and b is None) or torch.equal(a, b)
    # the CPU launches nothing
    assert profiling.COUNTS["adamw.launches"] == launches


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW kernel runs there only")
    return torch.device("cuda")


def _ulps(a, b):
    """The largest gap of fp32 tensors a and b in units of b's spacing."""
    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) \
        - b.abs()
    return float(((a - b).abs() / spacing).max())


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, WD])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_card_kernel_equals_plain(card, clip, wd):
    grad_clip, given = CLIPS[clip]
    opt = AdamW({"lr": LR, "weight_decay": wd, "grad_clip": grad_clip})
    grads, masters, mu, nu, weights = _tensors(card)
    plain = copy.deepcopy((masters, mu, nu, weights))
    before = profiling.COUNTS["adamw.launches"]
    norm_ulps = []
    for step in range(STEPS):
        scalars = _scalars(opt, step, card)
        norm = _norm(grads[step], masters) if given else None
        table = adamw.make_table(grads[step], masters, mu, nu, weights)
        adamw.adamw_step(grads[step], masters, mu, nu, weights, scalars,
                         wd, grad_clip, norm, table)
        if grad_clip and not given:
            norm = adamw.prepass_norm(table.partials)
            norm_ulps.append(_ulps(norm, _norm(grads[step], plain[0])))
        adamw.adamw_reference(grads[step], *plain, scalars, wd, grad_clip,
                              norm)
    torch.cuda.synchronize()
    for what, got, want in zip(("masters", "mu", "nu", "weights"),
                               (masters, mu, nu, weights), plain):
        for i, (a, b) in enumerate(zip(got, want)):
            assert (a is None and b is None) or torch.equal(a, b), \
                (what, i, float((a.float() - b.float()).abs().max()))
    launches = profiling.COUNTS["adamw.launches"] - before
    assert launches == STEPS * (2 if grad_clip and not given else 1)
    # the kernel's norm is the plain one's within a few ulps
    assert all(u <= 4 for u in norm_ulps), norm_ulps


@pytest.mark.cuda
def test_card_wrapper_raises_and_checks_its_table(card):
    grads, masters, mu, nu, weights = _tensors(card, mix=MIX[:4])
    scalars = _scalars(AdamW({"lr": LR}), 0, card)
    other = adamw.make_table(grads[1], masters, mu, nu, weights)
    with pytest.raises(ValueError, match="other tensors"):
        adamw.adamw_step(grads[0], masters, mu, nu, weights, scalars, WD,
                         0.0, table=other)
    with pytest.raises(TypeError, match="scalars"):
        adamw.adamw_step(grads[0], masters, mu, nu, weights,
                         [s.cpu() for s in scalars], WD, 0.0)


# ------------------------------------------------------------- the build

def _fake_nvcc(path, code):
    """A stand-in compiler: writes the library it is asked for, prints a
    register report and exits with ``code``."""
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 57 registers')\n"
        f"sys.exit({code})\n")
    path.chmod(0o755)
    return str(path)


def test_build_started_early_is_waited_for(tmp_path, monkeypatch):
    source = tmp_path / "k.cu"
    source.write_text("// kernel")
    library = tmp_path / "build" / "libk.so"
    monkeypatch.setattr(nvcc, "find_nvcc",
                        lambda: _fake_nvcc(tmp_path / "nvcc", 0))
    nvcc.start(source, library)
    compiler = nvcc._PENDING[library][0]
    nvcc.start(source, library)     # one compile under way, not two
    assert nvcc._PENDING[library][0] is compiler
    assert "57 registers" in nvcc.build(source, library)
    assert library.read_text() == "lib" and library not in nvcc._PENDING
    # up to date: nothing starts, nothing is built
    nvcc.start(source, library)
    assert library not in nvcc._PENDING
    assert nvcc.build(source, library) == ""


def test_failed_build_raises(tmp_path, monkeypatch):
    source = tmp_path / "k.cu"
    source.write_text("// kernel")
    library = tmp_path / "libk.so"
    monkeypatch.setattr(nvcc, "find_nvcc",
                        lambda: _fake_nvcc(tmp_path / "nvcc", 3))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nvcc.build(source, library)
    assert not library.exists()
