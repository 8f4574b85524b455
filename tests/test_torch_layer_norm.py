"""The guided denoiser's LayerNorms in their consumers' dtype
(``ops/layer_norm.py``).

- ``layer_norm_reference`` is bit-equal to the two-op path that
  ``TransformerDecoderLayer2Att.guided`` ran before it (``_replaced``: the
  fp32 ``LayerNorm`` and the cast inside the bf16 Linear that reads it; for
  ``TimeBlock``, its modulation with ``1 + scale`` rounded in bf16 and its
  SiLU first), for fp32 and bf16 inputs; on the CPU ``normalize`` is that
  version and counts nothing; with an fp32 consumer it hands on the fp32
  norm, and with an active dropout before the consumer the unrounded
  values, so that ``TimeBlock.guided`` equals ``TimeBlock.forward`` in
  training too.
- ``Denoiser.guided`` and ``Convofusion.sample`` at ``TINY`` are bit-equal
  to the same calls with every norm handed on in fp32, as before (the
  layers' norms through ``LayerNorm.forward``, ``TimeBlock.forward``), in
  bf16 and fp32, and to the per-layer route (each memory norm through
  ``normalize`` on its own, each variant's K/V through its own GEMM);
  ``guided`` routes 5 norms a layer and the final one through
  ``normalize`` and every layer's memory norms through one
  ``normalize_memory``, each with the module that reads it.
- ``memory_norms_reference`` is per (layer, stream, variant)
  ``layer_norm_reference``, bit for bit, for fp32 and bf16 rows, and
  ``normalize_memory`` is it on the CPU; ``memory_unsupported`` names every
  stream count, width, norm and eps the kernel's second entry does not
  take.
- ``plain_reason`` returns each of its reasons (the CPU, grad, a
  tensor-parallel consumer, an fp32 consumer) and nothing else;
  ``unsupported`` names every dtype, shape, stride and norm the kernel does
  not take, and ``normalize`` raises on such a call, and on an active
  dropout before the consumer, where ``plain_reason`` sends it to the
  kernel; the kernel takes any width that is a multiple of 4 up to
  ``MAX_D``; the ctypes layout matches the kernel's.
- The tests marked ``cuda`` hold the kernel to the plain version on a card
  (at most 1 bf16 ulp on at most 0.1% of the elements: PyTorch's build may
  contract another multiply-add than the kernel's) at every geometry of a
  production-width guided call at batch 32 and 1 (the first layer's
  expanded branches too) and at widths 64 (``TINY``), 96 and 1024, a CUDA
  graph's replay to
  the eager call (bit-equal), and count a production-geometry guided call's
  46 launches and 1 memory launch in a capture's warm-up and in the
  capture, none in a replay; they hold ``memory_norms`` bit-equal to the
  per-norm kernel and within the same ulps of the plain version at the
  production geometry (batch 32 and 1, 9 layers and 1) and at widths 64,
  96, 100, 612, 768 and 1024, and its graph replay to the eager call.
  They skip without a card; run them there with ``python -m pytest
  --noconftest -p no:cacheprovider -m cuda tests/test_torch_layer_norm.py
  -q``.
"""
import copy
import ctypes
import re
from unittest import mock

import pytest
import torch
from torch import nn

from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops import layer_norm as ln
from convofusion_tpu_torch.ops.attention import MultiheadAttention
from convofusion_tpu_torch.ops.layers import (
    Dropout,
    LayerNorm,
    Linear,
    dropout_generator,
)
from convofusion_tpu_torch.ops.transformer import COND_STREAMS, TimeBlock
from convofusion_tpu_torch.utils import profiling

BF16 = torch.bfloat16
D = 512
KEYS = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
        "active_passive_lsn", "lsn_id")
# the card: at most this many bf16 ulps on at most this share of elements
CARD_ULPS, CARD_DIFFER = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes on one intra-op thread: beside the other test workers,
    OpenMP teams as wide as the machine wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(d=D, device="cpu", seed=0, unit=False):
    norm = LayerNorm(d).to(device)
    if not unit:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            norm.weight.copy_(1 + 0.1 * torch.randn(d, generator=gen))
            norm.bias.copy_(0.1 * torch.randn(d, generator=gen))
    return norm


def _inputs(shape, dtype, mod=False, device="cpu", seed=0):
    """x of ``shape`` (G, B, T, D) in ``dtype``; with ``mod`` the bf16
    scale and shift (1, B, 1, D) as the halves of one projection."""
    gen = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=gen) + 0.3).to(device, dtype)
    if not mod:
        return x, None, None
    emb = 0.5 * torch.randn(1, shape[1], 1, 2 * shape[-1], generator=gen)
    scale, shift = emb.to(device, BF16).chunk(2, dim=-1)
    return x, scale, shift


def _replaced(norm, x, linear, scale=None, shift=None):
    """What the Linear after the norm computed on before: the fp32 norm
    (``LayerNorm.forward``), TimeBlock's modulation and SiLU (as
    ``TimeBlock.forward`` and its ``out_layers``), the Linear's cast."""
    h = norm(x)
    if scale is not None:
        h = nn.SiLU()(h * (1 + scale) + shift)
    return h.to(linear.weight.dtype)


# ------------------------------------------------- the plain version

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_reference_equals_replaced_code(dtype, mod, unit):
    x, scale, shift = _inputs((7, 3, 5, 64), dtype, mod, seed=int(mod))
    norm = _norm(64, unit=unit)
    linear = Linear(64, 8, dtype=BF16)
    want = _replaced(norm, x, linear, scale, shift)
    got = ln.layer_norm_reference(x, norm, BF16, scale, shift)
    assert got.dtype == BF16 and torch.equal(got, want)
    before = dict(profiling.COUNTS)
    with torch.no_grad():
        assert torch.equal(ln.normalize(norm, x, linear, scale, shift), want)
    assert profiling.COUNTS == before     # the CPU counts nothing
    # an fp32 consumer reads the fp32 norm
    linear32 = Linear(64, 8)
    assert torch.equal(ln.normalize(norm, x, linear32, scale, shift),
                       _replaced(norm, x, linear32, scale, shift))
    if mod:     # 1 + scale rounds in bf16, before the fp32 product
        one = 1 + scale
        assert one.dtype == BF16 and not torch.equal(
            one.float(), 1 + scale.float())


def test_timeblock_guided_equals_forward_with_active_dropout():
    """In training, TimeBlock's dropout comes between the SiLU and the
    Linear's cast: ``normalize`` hands on the unrounded values, and the
    masks come from the same draws."""
    tb = TimeBlock(64, BF16, dropout=0.1).train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tb.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    h = torch.randn(7, 3, 5, 64, generator=gen)
    emb = torch.randn(1, 3, 1, 64, generator=gen)
    out = []
    for fn in (tb.forward, tb.guided):
        with dropout_generator(torch.Generator().manual_seed(1)):
            out.append(fn(h, emb))
    assert torch.equal(*out)
    assert ln.plain_reason(_Card(), tb.out_layers[2]) == "grad is enabled"


# ------------------------------------------- the guided path, bit-equal

def _parent_paths(monkeypatch):
    """Every norm handed on in fp32, as the layers did before
    ``normalize``: the plain LayerNorm and ``TimeBlock.forward``."""
    monkeypatch.setattr(ln, "normalize",
                        lambda norm, x, consumer, *args: norm(x))
    monkeypatch.setattr(ln, "normalize_memory", lambda mems, norms: _stacked(
        mems, norms, lambda norm, x, consumer: norm(x)))
    monkeypatch.setattr(TimeBlock, "guided", TimeBlock.forward)


def _stacked(mems, norms, fn):
    """``memory_norms_reference``'s layout of ``fn(norm, x, consumer)``."""
    return torch.stack([torch.cat([
        fn(norm, x, consumer).reshape(-1, x.shape[-1])
        for (norm, consumer), pair in zip(layer, mems) for x in pair])
        for layer in norms])


def _per_layer_route(monkeypatch):
    """What ``guided`` computed before the memory norms went once a step:
    each memory norm through ``normalize`` on its own, and each variant's
    K/V through a GEMM of its own (their outputs in the merged layout)."""
    real_rows, project = {}, MultiheadAttention.project_kv

    def normalize_memory(mems, norms):
        for layer in norms:
            for (_, consumer), (real, _) in zip(layer, mems):
                real_rows[consumer] = real.numel() // real.shape[-1]
        return _stacked(mems, norms, ln.normalize)

    def project_kv(mod, rows):
        n = real_rows.get(mod)
        if n is None:
            return project(mod, rows)
        parts = zip(project(mod, rows[:n]), project(mod, rows[n:]))
        return tuple(torch.cat(t) for t in parts)

    monkeypatch.setattr(ln, "normalize_memory", normalize_memory)
    monkeypatch.setattr(MultiheadAttention, "project_kv", project_kv)


def _model(dtype, steps=3):
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=steps)
    return Convofusion(cfg, dtype=dtype, device="cpu", seed=0)


def _guided_and_sample(model, batch_size=2):
    """``Denoiser.guided`` at t 500 and ``Convofusion.sample`` from seeded
    draws."""
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, batch_size))
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(batch_size, model.latent_tokens, model.latent_dim,
                      generator=gen)
    init = torch.randn(lat.shape, generator=gen)
    steps = torch.randn((3,) + lat.shape, generator=gen)

    def run():
        with torch.no_grad():
            cond, masks = model.encode_conditions(*(batch[k] for k in KEYS))
            unc, umasks = model.encode_uncond(batch)
            guided = model.denoiser.guided(lat, 500, cond, unc, masks,
                                           umasks)
        return guided, model.sample(batch, init_noise=init,
                                    step_noise=steps)
    return run


def _assert_runs_equal(new, old, rtol=0.0, sample_rtol=0.0):
    """Bit-equal, or within these relative L2 gaps: ``rtol`` for guided's
    output and maps, ``sample_rtol`` for sample's motion and latents."""
    (g_new, a_new), s_new = new
    (g_old, a_old), s_old = old
    pairs = [(g_new, g_old, rtol)] + [
        (a_new[s], a_old[s], rtol) for s in COND_STREAMS] + [
        (a, b, sample_rtol) for a, b in zip(s_new, s_old)]
    for got, want, tol in pairs:
        if tol:
            gap = float((got - want).norm() / want.norm())
            assert gap <= tol, gap
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_guided_and_sample_equal_the_fp32_handoff(dtype, monkeypatch):
    run = _guided_and_sample(_model(dtype))
    new = run()
    with monkeypatch.context() as m:
        _parent_paths(m)
        _assert_runs_equal(new, run())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_guided_and_sample_equal_the_per_layer_route(dtype, monkeypatch):
    """One memory norm buffer for the stack and one K/V GEMM a (layer,
    stream) over both variants' rows give the per-layer route's numbers:
    the norms are the same elementwise arithmetic, bit-equal.  The GEMM is
    bit-equal in bf16; in fp32 the CPU's GEMM sums a row's products in an
    order that depends on the matrix's row count (another kernel for one
    or a few rows), a few fp32 ulps a K/V element (relative 3e-7 in
    guided's output), which the reverse loop carries on (8e-6 in the
    motion): relative L2 1e-6 and 1e-4."""
    run = _guided_and_sample(_model(dtype))
    new = run()
    with monkeypatch.context() as m:
        _per_layer_route(m)
        tols = (1e-6, 1e-4) if dtype == "float32" else (0.0, 0.0)
        _assert_runs_equal(new, run(), *tols)


def test_guided_routes_every_norm(monkeypatch):
    """``guided``'s norms go through ``normalize``, each with the module
    that reads it: per layer norm1 (self-attention), norm2 (the first
    stream's query projection), norm3 (linear1) and the TimeBlocks' (their
    Linear, with the epilogue); then the final norm (latent_proj).  The
    ten memory norms a layer go through one ``normalize_memory`` for the
    stack, with each stream's attention, over each stream's real and
    uncond memory."""
    model = _model("float32")
    den = model.denoiser
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    seen, memory = [], []
    plain, plain_memory = ln.normalize, ln.normalize_memory

    def spy(norm, x, consumer, scale=None, shift=None, dropout=None):
        seen.append((norm, consumer, scale is not None))
        return plain(norm, x, consumer, scale, shift, dropout)

    def spy_memory(mems, norms):
        memory.append(([tuple(map(id, pair)) for pair in mems],
                       [[tuple(map(id, n)) for n in layer]
                        for layer in norms]))
        return plain_memory(mems, norms)

    built = []
    build = den._build_memory
    monkeypatch.setattr(den, "_build_memory",
                        lambda *args: built.append(build(*args)) or
                        built[-1])
    monkeypatch.setattr(ln, "normalize", spy)
    monkeypatch.setattr(ln, "normalize_memory", spy_memory)
    with torch.no_grad():
        cond, masks = model.encode_conditions(*(batch[k] for k in KEYS))
        unc, umasks = model.encode_uncond(batch)
        den.guided(torch.zeros(2, model.latent_tokens, model.latent_dim),
                   500, cond, unc, masks, umasks)
    want = []
    for layer in den.decoder.layers:
        first = layer._cross(COND_STREAMS[0])[0]
        want += [(layer.norm1, layer.self_attn, False),
                 (layer.time_block1.norm, layer.time_block1.out_layers[2],
                  True),
                 (layer.norm2, first, False),
                 (layer.time_block2.norm, layer.time_block2.out_layers[2],
                  True),
                 (layer.norm3, layer.linear1, False)]
    want.append((den.decoder.norm, den.latent_proj, False))
    assert len(seen) == 5 * len(den.decoder.layers) + 1
    assert sorted(map(_ids, seen)) == sorted(map(_ids, want))
    mem_real, mem_unc = built
    assert memory == [(
        [(id(mem_real[s]), id(mem_unc[s])) for s in COND_STREAMS],
        [[(id(layer._cross(s)[1]), id(layer._cross(s)[0]))
          for s in COND_STREAMS] for layer in den.decoder.layers])]


def _ids(entry):
    norm, consumer, mod = entry
    return id(norm), id(consumer), mod


# ------------------------------------------------------------- the rule

class _Card:
    """x as the rule reads it on a card: a CUDA device."""
    device = torch.device("cuda")


@pytest.mark.parametrize("case", ["grad", "tp", "fp32", "none"])
def test_plain_reason_sends_these_calls_to_the_plain_version(case):
    consumer = Linear(8, 8, dtype=BF16)
    want = {"grad": "grad is enabled", "tp": "tensor-parallel",
            "fp32": "not bf16", "none": None}[case]
    if case == "tp":
        consumer.tp = object()
    elif case == "fp32":
        consumer = MultiheadAttention(8, 1, torch.float32)
    with torch.set_grad_enabled(case == "grad"):
        reason = ln.plain_reason(_Card(), consumer)
    assert reason == want if want is None else want in reason
    with torch.no_grad():
        assert ln.plain_reason(torch.zeros(2, D), consumer) == \
            "on cpu, not on a card"


@pytest.mark.parametrize("case", ["active", "eval", "p0"])
def test_active_dropout_on_the_kernel_route_raises(case, monkeypatch):
    """The kernel rounds to bf16 before a dropout that the consumer's cast
    would follow: on the kernel's route an active dropout raises, and an
    inactive one (in eval, or at p = 0) goes on to the kernel (here the
    CPU's refusal); the plain version hands on fp32 instead."""
    x, scale, shift = _inputs((7, 3, 5, D), BF16, mod=True)
    drop = {"active": Dropout(0.1).train(), "eval": Dropout(0.1).eval(),
            "p0": Dropout(0.0).train()}[case]
    linear = Linear(D, 8, dtype=BF16)
    with torch.no_grad():
        plain = ln.normalize(_norm(), x, linear, scale, shift, drop)
    assert plain.dtype == (torch.float32 if case == "active" else BF16)
    monkeypatch.setattr(ln, "plain_reason", lambda *args: None)
    want = "dropout" if case == "active" else "not on a card"
    before = dict(profiling.COUNTS)
    with torch.no_grad(), pytest.raises(ValueError, match=want):
        ln.normalize(_norm(), x, linear, scale, shift, drop)
    assert profiling.COUNTS == before


def _strided_scale(x, scale, shift):
    wide = torch.zeros(1, x.shape[1], 1, 3 * D, dtype=BF16)
    return x, wide[..., :D], shift


UNSUPPORTED = {
    "x_fp16": (lambda x, s, t: (x.half(), s, t), "not fp32 or bf16"),
    "x_width": (lambda x, s, t: (x[..., :98].contiguous(), None, None),
                "a multiple of 4"),
    "x_too_wide": (lambda x, s, t: (x.repeat(1, 1, 1, 3), None, None),
                   "up to 1024"),
    "norm_width": (lambda x, s, t: (x[..., :96].contiguous(), None, None),
                   "a norm over (512,)"),
    "x_strided": (lambda x, s, t: (x.transpose(1, 2), None, None),
                  "contiguous"),
    "scale_alone": (lambda x, s, t: (x, s, None), "without shift"),
    "scale_fp32": (lambda x, s, t: (x, s.float(), t), "not bf16"),
    "scale_shape": (lambda x, s, t: (x, s.expand(1, 3, 5, D), t),
                    "not bf16 (1, 3, 1, 512)"),
    "scale_stride": (_strided_scale, "strided as scale's"),
    "x_3d_with_mod": (lambda x, s, t: (x[0], s, t), "not 4-D"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED) + ["norm_bf16"])
def test_unsupported_names_what_the_kernel_does_not_take(case):
    x, scale, shift = _inputs((7, 3, 5, D), BF16, mod=True)
    norm = _norm()
    if case == "norm_bf16":
        norm, want = norm.to(BF16), "weight"
    else:
        edit, want = UNSUPPORTED[case]
        x, scale, shift = edit(x, scale, shift)
    reason = ln.unsupported(x, norm, scale, shift)
    assert reason is not None and want in reason, reason
    with pytest.raises(ValueError, match="layer_norm: "):
        ln.layer_norm(x, norm, scale, shift)


@pytest.mark.parametrize("case", sorted(UNSUPPORTED) + ["cpu"])
def test_the_kernel_route_raises_on_what_the_kernel_does_not_take(
        case, monkeypatch):
    """A call that ``plain_reason`` sends to the kernel and the kernel does
    not take raises in ``normalize``: the plain version does not stand in
    for it."""
    x, scale, shift = _inputs((7, 3, 5, D), BF16, mod=True)
    edit, want = UNSUPPORTED.get(case, (lambda *t: t, "not on a card"))
    x, scale, shift = edit(x, scale, shift)
    monkeypatch.setattr(ln, "plain_reason", lambda *args: None)
    before = dict(profiling.COUNTS)
    with torch.no_grad(), pytest.raises(ValueError, match=re.escape(want)):
        ln.normalize(_norm(), x, Linear(8, 8, dtype=BF16), scale, shift)
    assert profiling.COUNTS == before


def test_a_valid_cpu_call_fails_only_for_the_device():
    """Contiguous inputs, 2-D rows, the first layer's branches as one
    expanded (stride-0) tensor, and widths from 4 to 1024 (bf16 rows of an
    odd multiple of 4) are taken; the device is the last check."""
    x, scale, shift = _inputs((7, 3, 5, D), torch.float32, mod=True)
    expanded = x[0][None].expand(x.shape)
    for case in ((x, scale, shift), (x.reshape(-1, D), None, None),
                 (expanded, scale, shift), (x[:, :2], None, None)):
        assert ln.unsupported(case[0], _norm(), *case[1:]) == \
            "on cpu, not on a card"
    for d, dtype in ((4, BF16), (64, torch.float32), (68, BF16),
                     (1024, torch.float32)):
        x, scale, shift = _inputs((7, 3, 5, d), dtype, mod=True)
        assert ln.unsupported(x, _norm(d), scale, shift) == \
            "on cpu, not on a card"


def test_ctypes_layout_and_geometry():
    # csrc Params: 6 pointers, 4 int64, 4 int32 and a float, padded to 8
    assert ctypes.sizeof(ln._CParams) == 6 * 8 + 4 * 8 + 5 * 4 + 4
    assert ln._eps(1e-5) == float(torch.tensor(1e-5, dtype=torch.float32))
    x, scale, _ = _inputs((7, 3, 5, D), BF16, mod=True)
    assert ln.geometry(x, scale) == (105, D, "bfloat16", (5, 3))
    assert ln.geometry(x[0].float()) == (15, D, "float32", None)


# ----------------------------------------------------- the memory norms

# each stream's memory (Tk, dtype) at the published geometry: every row is
# fp32 in a bf16 model (the bf16 conditions plus fp32 position encodings);
# "mixed" stores three streams in bf16
MEMORY_TK = {"spkemb": 64, "alsn": 161, "tlsn": 64, "apb": 8, "lsnemb": 1}
MEMORY_DTYPES = {
    "fp32": {s: torch.float32 for s in COND_STREAMS},
    "bf16": {s: BF16 for s in COND_STREAMS},
    "mixed": {"spkemb": BF16, "alsn": BF16, "tlsn": BF16,
              "apb": torch.float32, "lsnemb": torch.float32}}


def _memories(b, d, dtypes="fp32", device="cpu", seed=0, unc_batch=1,
              tk=None):
    """(real (b, Tk, d), uncond (unc_batch, Tk, d)) a stream."""
    gen = torch.Generator().manual_seed(seed)
    tk = tk or MEMORY_TK
    return [tuple((2 * torch.randn(n, tk[s], d, generator=gen) + 0.3).to(
        device, MEMORY_DTYPES[dtypes][s]) for n in (b, unc_batch))
        for s in COND_STREAMS]


def _memory_norms(layers, d, device="cpu", seed=0, consumer=None):
    """(norm, consumer) a stream a layer, each norm drawn."""
    consumer = consumer or Linear(8, 8, dtype=BF16).to(device)
    return [[(_norm(d, device, seed=seed + 10 * i + j), consumer)
             for j in range(len(COND_STREAMS))] for i in range(layers)]


@pytest.mark.parametrize("dtypes", ["fp32", "bf16", "mixed"])
@pytest.mark.parametrize("geom", [(2, 64, 3), (1, D, 2)])
def test_memory_reference_is_each_norm_in_turn(dtypes, geom):
    """Per layer the streams' real then uncond rows, each through that
    layer's norm of the stream and rounded to its consumer's dtype: the
    per-norm plain version, bit for bit, at TINY's width and at the
    published one; ``normalize_memory`` is it on the CPU and counts
    nothing, and hands an fp32 consumer the fp32 norms."""
    b, d, layers = geom
    mems = _memories(b, d, dtypes, unc_batch=b if dtypes == "bf16" else 1)
    norms = _memory_norms(layers, d)
    got = ln.memory_norms_reference(mems, norms)
    rows = sum(x.numel() // d for pair in mems for x in pair)
    assert got.shape == (layers, rows, d) and got.dtype == BF16
    for i, layer in enumerate(norms):
        blocks = got[i].split([sum(x.numel() // d for x in pair)
                               for pair in mems])
        for (norm, consumer), pair, block in zip(layer, mems, blocks):
            want = torch.cat([ln.layer_norm_reference(
                x, norm, BF16).reshape(-1, d) for x in pair])
            assert torch.equal(block, want)
    before = dict(profiling.COUNTS)
    with torch.no_grad():
        assert torch.equal(ln.normalize_memory(mems, norms), got)
        fp32 = ln.normalize_memory(mems, _memory_norms(
            layers, d, consumer=Linear(8, 8)))
    assert profiling.COUNTS == before
    assert fp32.dtype == torch.float32 and torch.equal(fp32.to(BF16), got)


def test_memory_reference_is_differentiable():
    """Under grad (WEG's gradient pass) the plain version's buffer carries
    gradients to the memories and the norms' weights."""
    mems = _memories(2, 64)
    mems[0][0].requires_grad_(True)
    norms = _memory_norms(2, 64)
    ln.normalize_memory(mems, norms).float().sum().backward()
    assert mems[0][0].grad is not None
    assert norms[1][0][0].weight.grad is not None


def _other_eps(mems, norms):
    norms[1][2][0].eps = 1e-6
    return mems, norms


def _no_bias(mems, norms):
    norms[0][1] = (nn.LayerNorm(D, bias=False), norms[0][1][1])
    return mems, norms


MEMORY_UNSUPPORTED = {
    "streams": (lambda m, n: (m * 2, [layer * 2 for layer in n]),
                "10 streams (1 to 8)"),
    "norms_a_layer": (lambda m, n: (m, [n[0], n[1][:4]]), "norms a layer"),
    "x_fp16": (lambda m, n: ([(m[0][0].half(), m[0][1])] + m[1:], n),
               "not fp32 or bf16"),
    "x_strided": (lambda m, n: ([(m[0][0].transpose(0, 1), m[0][1])] +
                                m[1:], n), "contiguous"),
    "widths": (lambda m, n: (m[:4] + [tuple(
        x[..., :96].contiguous() for x in m[4])], n), "widths 96 and 512"),
    "norm_bf16": (lambda m, n: (m, [n[0], [(n[1][0][0].to(BF16),
                                            n[1][0][1])] + n[1][1:]]),
                  "weight"),
    "no_bias": (_no_bias, "without weight and bias"),
    "eps": (_other_eps, "eps"),
}


@pytest.mark.parametrize("case", sorted(MEMORY_UNSUPPORTED) + ["cpu"])
def test_memory_unsupported_names_what_the_kernel_does_not_take(
        case, monkeypatch):
    """``memory_unsupported`` names the first thing the second entry does
    not take, the device last; a call that ``plain_reason`` sends to the
    kernel raises in ``normalize_memory`` and counts nothing."""
    mems, norms = _memories(2, D), _memory_norms(2, D)
    edit, want = MEMORY_UNSUPPORTED.get(
        case, (lambda m, n: (m, n), "on cpu, not on a card"))
    mems, norms = edit(mems, norms)
    reason = ln.memory_unsupported(mems, norms)
    assert reason is not None and want in reason, reason
    monkeypatch.setattr(ln, "plain_reason", lambda *args: None)
    before = dict(profiling.COUNTS)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="memory_norms: "):
        ln.normalize_memory(mems, norms)
    assert profiling.COUNTS == before


def test_memory_rule_reads_every_consumer():
    """One consumer with a reason (here a tensor-parallel placement) sends
    every memory norm to the plain version."""
    mems, norms = _memories(2, 64), _memory_norms(2, 64)
    tp = Linear(8, 8, dtype=BF16)
    tp.tp = object()
    norms[1][3] = (norms[1][3][0], tp)
    reasons = []
    rule = ln.plain_reason

    def spy(x, consumer):
        reasons.append(rule(_Card(), consumer))
        return reasons[-1]

    with torch.no_grad(), mock.patch.object(ln, "plain_reason", spy):
        got = ln.normalize_memory(mems, norms)
    assert reasons[-1] == "a tensor-parallel placement"
    assert reasons[:-1] == [None] * (len(reasons) - 1) and \
        len(reasons) == 5 + 4
    assert torch.equal(got, ln.memory_norms_reference(mems, norms))


def test_memory_ctypes_layout_and_geometry():
    # csrc MemParams: 16 segments of a pointer, 3 int64 and an int (40
    # bytes each), 8 + 9 int64, 2 x 128 pointers, a pointer, an int64,
    # 3 int32 and a float
    assert ctypes.sizeof(ln._CSegment) == 40
    assert ctypes.sizeof(ln._CMemParams) == \
        16 * 40 + 17 * 8 + 256 * 8 + 8 + 8 + 4 * 4
    mems = _memories(2, D, "mixed")
    assert ln.memory_geometry(mems, 9) == (9, D, (
        (128, 64, "bfloat16", "bfloat16"), (322, 161, "bfloat16",
                                            "bfloat16"),
        (128, 64, "bfloat16", "bfloat16"), (16, 8, "float32", "float32"),
        (2, 1, "float32", "float32")))


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LayerNorm kernel runs there "
                    "only")
    return torch.device("cuda")


def _ordered(t):
    """bf16 bit patterns as integers in the order of the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i + 32768), i)


def _compare(got, want, what):
    ulps = int((_ordered(got) - _ordered(want)).abs().max())
    differ = float((got != want).float().mean())
    print(f"{what}: {ulps} bf16 ulps, {differ:.4%} of elements differ")
    assert ulps <= CARD_ULPS and differ <= CARD_DIFFER, (what, ulps, differ)


# a guided call at batch B: the query side (7, B, 16) fp32 with and without
# the epilogue, the memory rows (B or 1, Tk) of each stream in its dtype;
# the same sides at TINY's width 64, and at 96 and 1024 (two vectors a
# thread)
CARD_GEOMETRIES = [
    ((7, b, 16, D), torch.float32, mod) for b in (32, 1)
    for mod in (False, True)] + [
    ((0, 32, 16, D), torch.float32, False)] + [
    ((rows, tk, D), dtype, False) for rows in (32, 1)
    for tk, dtype in ((64, BF16), (161, BF16), (8, torch.float32),
                      (1, torch.float32))] + [
    ((7, 2, 16, d), torch.float32, mod) for d in (64, 96, 1024)
    for mod in (False, True)] + [
    ((2, 64, d), BF16, False) for d in (64, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("case", range(len(CARD_GEOMETRIES)))
def test_card_kernel_against_plain(card, case, unit):
    shape, dtype, mod = CARD_GEOMETRIES[case]
    expand = shape[0] == 0      # the first layer's expanded branches
    if expand:
        shape = (1,) + shape[1:]
    x, scale, shift = _inputs(shape, dtype, mod, device=card, seed=case)
    if expand:
        x = x.expand((7,) + shape[1:])
    norm = _norm(shape[-1], device=card, seed=case, unit=unit)
    linear = Linear(8, 8, dtype=BF16).to(card)
    with torch.no_grad():
        assert ln.plain_reason(x, linear) is None
        launches = profiling.COUNTS["layer_norm.launches"]
        got = ln.normalize(norm, x, linear, scale, shift)
        assert profiling.COUNTS["layer_norm.launches"] == launches + 1
        want = ln.layer_norm_reference(x, norm, BF16, scale, shift)
    torch.cuda.synchronize()
    _compare(got, want, f"{shape} {dtype} epilogue {mod} unit {unit}")


@pytest.mark.cuda
def test_card_call_the_kernel_cannot_take_raises(card):
    """bf16, grad off, on the card, at D 98: no reason of the rule, so the
    kernel route raises, and no plain call is counted."""
    x, _, _ = _inputs((7, 2, 16, 98), BF16, device=card)
    plain = profiling.COUNTS["layer_norm.plain"]
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of 4"):
        ln.normalize(_norm(98, device=card), x,
                     Linear(98, 8, dtype=BF16).to(card))
    assert profiling.COUNTS["layer_norm.plain"] == plain


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(card):
    from convofusion_tpu_torch.utils import cuda_graphs

    x, scale, shift = _inputs((7, 32, 16, D), torch.float32, True,
                              device=card)
    norm = _norm(device=card)
    static = x.clone()
    with torch.no_grad():
        graph, out = cuda_graphs.GraphPool().capture(
            lambda: ln.layer_norm(static, norm, scale, shift), card)
        static.copy_(_inputs((7, 32, 16, D), torch.float32, device=card,
                             seed=1)[0])
        launches = profiling.COUNTS["layer_norm.launches"]
        graph.replay()
        eager = ln.layer_norm(static, norm, scale, shift)
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert profiling.COUNTS["layer_norm.launches"] == launches + 1


# memory_norms on the card: (batch, width, layers, stream dtypes, uncond
# batch); every instance (D 512 and 1024, chunks of 8 and of 4 below and
# above 512) and, at 30 layers, two launches
CARD_MEMORY = [
    (32, D, 9, "fp32", 1), (32, D, 9, "mixed", 1), (1, D, 9, "fp32", 1),
    (32, D, 1, "fp32", 1), (32, D, 9, "bf16", 32), (2, 64, 9, "mixed", 1),
    (2, 96, 9, "fp32", 1), (2, 100, 3, "mixed", 1),
    (2, 612, 3, "mixed", 1), (2, 768, 3, "fp32", 1),
    (2, 1024, 9, "mixed", 1), (2, 64, 30, "fp32", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_MEMORY)))
def test_card_memory_kernel_equals_per_norm_kernel(card, case):
    b, d, layers, dtypes, unc = CARD_MEMORY[case]
    mems = _memories(b, d, dtypes, card, seed=case, unc_batch=unc)
    norms = _memory_norms(layers, d, card, seed=case)
    per_launch = ln.MAX_NORMS // len(mems)
    with torch.no_grad():
        assert ln.plain_reason(mems[0][0], norms[0][0][1]) is None
        launches = profiling.COUNTS["layer_norm.memory_launches"]
        got = ln.normalize_memory(mems, norms)
        assert profiling.COUNTS["layer_norm.memory_launches"] == \
            launches + -(-layers // per_launch)
        per_norm = _stacked(mems, norms,
                            lambda norm, x, _: ln.layer_norm(x, norm))
        want = ln.memory_norms_reference(mems, norms)
    torch.cuda.synchronize()
    assert torch.equal(got, per_norm)
    _compare(got, want, f"memory b {b} d {d} layers {layers} {dtypes} "
                        f"uncond batch {unc}")


@pytest.mark.cuda
def test_card_memory_graph_replay_equals_eager(card):
    """A replay reads new memories and a weight updated in place since the
    capture, as the eager call does."""
    from convofusion_tpu_torch.utils import cuda_graphs

    norms = _memory_norms(9, D, card)
    static = _memories(32, D, "mixed", card)
    with torch.no_grad():
        graph, out = cuda_graphs.GraphPool().capture(
            lambda: ln.memory_norms(static, norms), card)
        for pair, new in zip(static, _memories(32, D, "mixed", card, 1)):
            for x, y in zip(pair, new):
                x.copy_(y)
        norms[4][2][0].weight.mul_(1.5)
        launches = profiling.COUNTS["layer_norm.memory_launches"]
        graph.replay()
        eager = ln.memory_norms(static, norms)
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert profiling.COUNTS["layer_norm.memory_launches"] == launches + 1


@pytest.mark.cuda
def test_card_guided_denoiser_counts(card):
    """A production-geometry guided denoiser in bf16: 46 launches (5 norms
    a layer and the final one) and 1 memory launch at a capture's warm-up
    and as many in the capture, none on a replay, no plain call; fp32 and
    grad-enabled calls on the card take the plain version and count it,
    the memory norms once a call."""
    from convofusion_tpu_torch.config import PRODUCTION
    from convofusion_tpu_torch.models.denoiser import Denoiser
    from convofusion_tpu_torch.utils import cuda_graphs

    den = Denoiser(latent_dim=128, **PRODUCTION["denoiser"],
                   dtype=BF16).to(card).eval()
    gen = torch.Generator(device=card).manual_seed(0)
    tk = {"spkemb": 64, "alsn": 161, "tlsn": 64, "apb": 8, "lsnemb": 1}
    real = {s: torch.randn(32, tk[s], D, generator=gen, device=card).to(BF16)
            for s in COND_STREAMS}
    unc = {s: torch.randn(1, tk[s], D, generator=gen, device=card).to(BF16)
           for s in COND_STREAMS}
    lat = torch.randn(32, 16, 128, generator=gen, device=card)
    t = torch.tensor(500, device=card)
    n = 5 * len(den.decoder.layers) + 1

    def counts():
        return (profiling.COUNTS["layer_norm.launches"],
                profiling.COUNTS["layer_norm.memory_launches"],
                profiling.COUNTS["layer_norm.plain"])

    with torch.no_grad():
        before = counts()
        graph, outs = cuda_graphs.GraphPool().capture(
            lambda: den.guided(lat, t, real, unc), card)
        assert counts() == (before[0] + 2 * n, before[1] + 2, before[2])
        graph.replay()
        eager = den.guided(lat, t, real, unc)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 3 * n, before[1] + 3, before[2])
        assert torch.equal(outs[0], eager[0])
    with torch.enable_grad():
        den.guided(lat, t, real, unc)
    assert counts() == (before[0] + 3 * n, before[1] + 3,
                        before[2] + n + 1)
    with torch.no_grad():
        den.float()
        den.guided(lat, t, {s: c.float() for s, c in real.items()},
                   {s: c.float() for s, c in unc.items()})
    assert counts() == (before[0] + 3 * n, before[1] + 3,
                        before[2] + 2 * (n + 1))
