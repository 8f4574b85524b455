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
  bf16 and fp32; ``guided`` routes its 15 norms a layer and the final one
  through ``normalize`` with the modules that read them.
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
  136 launches in a capture's warm-up and in the capture, none in a replay.
  They skip without a card; run them there with ``python -m pytest
  --noconftest -p no:cacheprovider -m cuda tests/test_torch_layer_norm.py
  -q``.
"""
import copy
import ctypes
import re

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
    monkeypatch.setattr(TimeBlock, "guided", TimeBlock.forward)


def _model(dtype, steps=3):
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=steps)
    return Convofusion(cfg, dtype=dtype, device="cpu", seed=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_guided_and_sample_equal_the_fp32_handoff(dtype, monkeypatch):
    model = _model(dtype)
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(2, model.latent_tokens, model.latent_dim,
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

    (g_new, a_new), s_new = run()
    with monkeypatch.context() as m:
        _parent_paths(m)
        (g_old, a_old), s_old = run()
    assert torch.equal(g_new, g_old)
    assert all(torch.equal(a_new[s], a_old[s]) for s in COND_STREAMS)
    assert all(torch.equal(a, b) for a, b in zip(s_new, s_old))


def test_guided_routes_every_norm(monkeypatch):
    """``guided``'s norms go through ``normalize``, each with the module
    that reads it: per layer the ten memory norms (the stream's attention),
    norm1 (self-attention), norm2 (the first stream's query projection),
    norm3 (linear1) and the TimeBlocks' (their Linear, with the epilogue);
    then the final norm (latent_proj)."""
    model = _model("float32")
    den = model.denoiser
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    seen = []
    plain = ln.normalize

    def spy(norm, x, consumer, scale=None, shift=None, dropout=None):
        seen.append((norm, consumer, scale is not None))
        return plain(norm, x, consumer, scale, shift, dropout)

    monkeypatch.setattr(ln, "normalize", spy)
    with torch.no_grad():
        cond, masks = model.encode_conditions(*(batch[k] for k in KEYS))
        unc, umasks = model.encode_uncond(batch)
        den.guided(torch.zeros(2, model.latent_tokens, model.latent_dim),
                   500, cond, unc, masks, umasks)
    want = []
    for layer in den.decoder.layers:
        for s in COND_STREAMS:
            mod, norm = layer._cross(s)
            want += [(norm, mod, False)] * 2
        first = layer._cross(COND_STREAMS[0])[0]
        want += [(layer.norm1, layer.self_attn, False),
                 (layer.time_block1.norm, layer.time_block1.out_layers[2],
                  True),
                 (layer.norm2, first, False),
                 (layer.time_block2.norm, layer.time_block2.out_layers[2],
                  True),
                 (layer.norm3, layer.linear1, False)]
    want.append((den.decoder.norm, den.latent_proj, False))
    assert len(seen) == 15 * len(den.decoder.layers) + 1
    assert sorted(map(_ids, seen)) == sorted(map(_ids, want))


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


@pytest.mark.cuda
def test_card_guided_denoiser_counts(card):
    """A production-geometry guided denoiser in bf16: 136 launches at a
    capture's warm-up and 136 in the capture, none on a replay, no plain
    call; fp32 and grad-enabled calls on the card take the plain version
    and count it."""
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
    n = 15 * len(den.decoder.layers) + 1

    def counts():
        return (profiling.COUNTS["layer_norm.launches"],
                profiling.COUNTS["layer_norm.plain"])

    with torch.no_grad():
        before = counts()
        graph, outs = cuda_graphs.GraphPool().capture(
            lambda: den.guided(lat, t, real, unc), card)
        assert counts() == (before[0] + 2 * n, before[1])
        graph.replay()
        eager = den.guided(lat, t, real, unc)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 3 * n, before[1])
        assert torch.equal(outs[0], eager[0])
    with torch.enable_grad():
        den.guided(lat, t, real, unc)
    assert counts() == (before[0] + 3 * n, before[1] + n)
    with torch.no_grad():
        den.float()
        den.guided(lat, t, {s: c.float() for s, c in real.items()},
                   {s: c.float() for s, c in unc.items()})
    assert counts() == (before[0] + 3 * n, before[1] + 2 * n)
