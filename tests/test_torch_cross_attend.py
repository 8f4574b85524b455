"""The guided denoiser's cross-attention core (``ops/cross_attend.py``).

- ``cross_attend_reference`` is bit-equal to the gather, attend and scatter
  that ``TransformerDecoderLayer2Att.guided`` ran inline (``_replaced``,
  copied from it), for every stream's branch table, batch-1 and batch-B
  uncond K/V, masks with a fully padded row, Tq 16 and 128, Tk 1, 8, 64
  and 161; on the CPU ``grouped_cross_attend`` is that version and counts
  nothing.  ``guided``'s parity with JAX stays with the tests of the
  denoiser (``test_torch_denoiser.py``, ``test_torch_bf16.py``).
- ``plain_reason`` sends calls on the CPU, under grad, with a
  tensor-parallel placement, with active attention dropout, in fp32 or
  with a Tk whose row does not fit a block to the plain version, and no
  other call; ``unsupported`` names every shape, stride and size the
  kernel does not take, and ``grouped_cross_attend`` raises on such a call
  where ``plain_reason`` sends it to the kernel; ``shared_bytes`` and the
  ctypes layout match the kernel's.
- The tests marked ``cuda`` hold the kernel to the plain version on a card
  (relative RMS at most 1e-2 on the output and the weights; the largest
  gap in bf16 ulps is printed) at the published geometry for every stream,
  at batch 1 and 96, at Tq 128 (raw motion), with batch-B uncond K/V and
  fully padded rows, through ``grouped_cross_attend`` as ``guided`` calls
  it; a bf16 call on the card that the kernel cannot take raises and
  counts no plain call; a CUDA graph's replay is bit-equal to the eager call;
  a production-geometry guided denoiser launches the kernel 45 times in a
  capture's warm-up and 45 in the capture, none on a replay, and takes
  the plain version only in fp32 or under grad.  They skip
  without a card; run them there with ``python -m pytest --noconftest -p
  no:cacheprovider -m cuda tests/test_torch_cross_attend.py -q -s``.
"""
import ctypes

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.ops import cross_attend as ca
from convofusion_tpu_torch.ops import transformer
from convofusion_tpu_torch.ops.attention import MultiheadAttention
from convofusion_tpu_torch.ops.transformer import (
    COND_STREAMS,
    NUM_BRANCHES,
    REAL_BRANCHES,
)
from convofusion_tpu_torch.utils import profiling

BF16 = torch.bfloat16
D_CPU = 32
# the published geometry: (7, 32, 16, 512); each stream's Tk and whether
# it has a padding mask (the two text streams)
PUBLISHED_TK = {"spkemb": 64, "alsn": 161, "tlsn": 64, "apb": 8,
                "lsnemb": 1}
MASKED = ("spkemb", "tlsn")
CARD_RTOL = 1e-2


def _replaced(mod, q_all, kv_real, kv_unc, mask_real, mask_unc, r_idx,
              u_idx):
    """The lines of ``guided`` that ``grouped_cross_attend`` replaced."""
    (k_r, v_r), (k_u, v_u) = kv_real, kv_unc
    o_r, w_r = mod.grouped_attend(q_all.index_select(0, r_idx),
                                  k_r, v_r, mask_real)
    o_u, _ = mod.grouped_attend(q_all.index_select(0, u_idx),
                                k_u, v_u, mask_unc)
    out = torch.empty_like(q_all)
    out.index_copy_(0, r_idx, o_r)
    out.index_copy_(0, u_idx, o_u)
    return out, w_r[-1]


def _indices(stream, device="cpu"):
    real = REAL_BRANCHES[stream]
    return (torch.tensor(real, device=device),
            torch.tensor(ca.unc_branches(real, NUM_BRANCHES), device=device))


def _inputs(b, tq, d, tk, unc_batch, masked, device="cpu", dtype=BF16,
            seed=0):
    """q_all (7, B, Tq, D); each variant's K/V as the halves of one (B or
    1, Tk, 2D) projection, as ``project_kv`` gives them; masks (B, Tk) and
    (unc_batch, Tk) with every key of the first row padded, or None."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device, dtype)

    q = randn(NUM_BRANCHES, b, tq, d)
    kv_r = randn(b, tk, 2 * d).chunk(2, dim=-1)
    kv_u = randn(unc_batch, tk, 2 * d).chunk(2, dim=-1)
    masks = (None, None)
    if masked:
        m_r = torch.rand(b, tk, generator=gen) < 0.3
        m_u = torch.rand(unc_batch, tk, generator=gen) < 0.3
        m_r[0] = True
        m_u[0] = True
        masks = (m_r.to(device), m_u.to(device))
    return q, kv_r, kv_u, masks


def _mod(d, dtype=BF16, device="cpu"):
    return MultiheadAttention(d, 1, dtype).to(device)


# ------------------------------------------------- the plain version

@pytest.mark.parametrize("stream", COND_STREAMS)
@pytest.mark.parametrize("tk", [1, 8, 64, 161])
@pytest.mark.parametrize("tq", [16, 128])
@pytest.mark.parametrize("unc_batch", ["one", "batch"])
def test_reference_equals_replaced_code(stream, tk, tq, unc_batch):
    b = 3
    q, kv_r, kv_u, (m_r, m_u) = _inputs(
        b, tq, D_CPU, tk, 1 if unc_batch == "one" else b, masked=True,
        seed=tk + tq)
    mod = _mod(D_CPU)
    r_idx, u_idx = _indices(stream)
    want = _replaced(mod, q, kv_r, kv_u, m_r, m_u, r_idx, u_idx)
    got = ca.cross_attend_reference(mod, q, kv_r, kv_u, m_r, m_u, r_idx,
                                    u_idx)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    # the fully padded row's weights are uniform, as -1e9 (not -inf) gives
    assert torch.equal(got[1][0], torch.full_like(got[1][0], 1.0 / tk))
    with torch.no_grad():
        before = dict(profiling.COUNTS)
        dispatched = ca.grouped_cross_attend(
            mod, q, kv_r, kv_u, m_r, m_u, REAL_BRANCHES[stream], r_idx,
            u_idx)
    for a, w in zip(dispatched, want):
        assert torch.equal(a, w)
    # the CPU takes the plain version without counting it
    assert profiling.COUNTS == before


def test_guided_calls_the_core_for_each_stream(monkeypatch):
    """``guided`` routes every stream of every layer through
    ``grouped_cross_attend``, with the stream's branch table."""
    from convofusion_tpu_torch.config import TINY
    from convofusion_tpu_torch.data.synthetic import (
        prepare_arrays,
        synthetic_raw_batch,
    )
    from convofusion_tpu_torch.models.convofusion import Convofusion

    seen = []
    plain = transformer.grouped_cross_attend

    def spy(mod, q_all, *args):
        seen.append((mod, args[4]))
        return plain(mod, q_all, *args)

    model = Convofusion(TINY, dtype="float32", device="cpu", seed=0)
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    with torch.no_grad():
        cond, masks = model.encode_conditions(*(batch[k] for k in keys))
        unc, umasks = model.encode_uncond(batch)
        lat = torch.randn(2, model.latent_tokens, model.latent_dim)
        want = model.denoiser.guided(lat, 500, cond, unc, masks, umasks)
        monkeypatch.setattr(transformer, "grouped_cross_attend", spy)
        got = model.denoiser.guided(lat, 500, cond, unc, masks, umasks)
    layers = model.denoiser.decoder.layers
    assert [(m, r) for m, r in seen] == [
        (layer._cross(s)[0], REAL_BRANCHES[s]) for layer in layers
        for s in COND_STREAMS]
    assert torch.equal(got[0], want[0])


# ------------------------------------------------------------- the rule

def _valid(device="cpu", b=2, tq=16, d=512, tk=8, unc_batch=1):
    return _inputs(b, tq, d, tk, unc_batch, masked=True, device=device)


def _reason(mod, q, kv_r, kv_u):
    return ca.plain_reason(mod, q, kv_r, kv_u)


def test_plain_reason_on_the_cpu():
    """bf16 CPU tensors of a shape the kernel takes: the rule's first
    reason, and ``unsupported``'s last."""
    q, kv_r, kv_u, masks = _valid()
    with torch.no_grad():
        assert _reason(_mod(512), q, kv_r, kv_u) == \
            "on cpu, not on a card"
        assert ca.unsupported(q, kv_r, kv_u, *masks, (1, 6)) == \
            "on cpu, not on a card"


class _Card:
    """q_all as the rule reads it on a card: its dtype and shape, and a
    CUDA device."""
    device = torch.device("cuda")

    def __init__(self, q):
        self.dtype, self.shape = q.dtype, q.shape


@pytest.mark.parametrize("case", ["grad", "tp", "dropout", "tk", "fp32"])
def test_plain_reason_sends_these_calls_to_the_plain_version(case):
    q, kv_r, kv_u, masks = _valid()
    mod = _mod(512)
    want = {"grad": "grad is enabled", "tp": "tensor-parallel",
            "dropout": "attention dropout", "tk": "shared memory",
            "fp32": "not bf16"}[case]
    if case == "tp":
        mod.tp = object()
    elif case == "dropout":
        mod = MultiheadAttention(512, 1, BF16, dropout=0.1).train()
    elif case == "tk":
        kv_r = tuple(t.repeat(1, 120, 1) for t in kv_r)
    elif case == "fp32":
        q = q.float()
    with torch.set_grad_enabled(case == "grad"):
        assert want in ca.plain_reason(mod, _Card(q), kv_r, kv_u)
    if case == "dropout":   # inactive dropout: in eval, or at p = 0
        with torch.no_grad():
            assert ca.plain_reason(mod.eval(), _Card(q), kv_r, kv_u) is None
            mod = MultiheadAttention(512, 1, BF16, dropout=0.0).train()
            assert ca.plain_reason(mod, _Card(q), kv_r, kv_u) is None


def _misaligned(kv):
    """K/V views one element off their rows' 16-byte alignment."""
    k, v = kv
    buf = torch.zeros(k.shape[0], k.shape[1], k.shape[2] + 1, dtype=BF16)
    return buf[..., 1:], v


UNSUPPORTED = {
    "q_fp32": (lambda q, r, u, m: (q.float(), r, u, m), "not bf16"),
    "q_strided": (lambda q, r, u, m: (q.transpose(1, 2), r, u, m),
                  "not contiguous"),
    "d_96": (lambda q, r, u, m: (q[..., :96].contiguous(),
                                 tuple(t[..., :96] for t in r),
                                 tuple(t[..., :96] for t in u), m),
             "not 512"),
    "kv_fp32": (lambda q, r, u, m: (q, tuple(t.float() for t in r), u, m),
                "not bf16"),
    "kv_batch": (lambda q, r, u, m: (q, r, tuple(torch.cat([t, t]).repeat(
        2, 1, 1)[:3] for t in u), m), "batch 3"),
    "kv_shapes": (lambda q, r, u, m: (q, (r[0], r[1][:, :4]), u, m),
                  "shapes"),
    "kv_misaligned": (lambda q, r, u, m: (q, _misaligned(r), u, m),
                      "aligned"),
    "mask_dtype": (lambda q, r, u, m: (q, r, u, (m[0].int(), m[1])),
                   "mask"),
    "mask_length": (lambda q, r, u, m: (q, r, u, (m[0], m[1][:, :4])),
                    "mask"),
    "mask_batch": (lambda q, r, u, m: (q, r, u, (m[0].repeat(2, 1)[:3],
                                                 m[1])), "mask"),
    "tk_too_long": (lambda q, r, u, m: (q, tuple(t.repeat(1, 120, 1)
                                                 for t in r), u,
                                        (None, m[1])), "shared memory"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_names_what_the_kernel_does_not_take(case):
    edit, want = UNSUPPORTED[case]
    q, kv_r, kv_u, masks = edit(*_valid())
    reason = ca.unsupported(q, kv_r, kv_u, *masks, REAL_BRANCHES["alsn"])
    assert reason is not None and want in reason, reason
    with pytest.raises(ValueError, match="cross_attend: "):
        ca.cross_attend(q, kv_r, kv_u, *masks, REAL_BRANCHES["alsn"])


# what the rule sends to the kernel although the kernel does not take it
RAISED = sorted(set(UNSUPPORTED) - {"q_fp32", "tk_too_long"})


@pytest.mark.parametrize("case", RAISED + ["cpu"])
def test_the_kernel_route_raises_on_what_the_kernel_does_not_take(
        case, monkeypatch):
    """A call that ``plain_reason`` sends to the kernel and the kernel does
    not take raises in ``grouped_cross_attend``: the plain version does
    not stand in for it."""
    edit, want = UNSUPPORTED.get(case, (lambda *t: t, "not on a card"))
    q, kv_r, kv_u, masks = edit(*_valid())
    real = REAL_BRANCHES["alsn"]
    r_idx, u_idx = _indices("alsn")
    with torch.no_grad():   # on a card, the rule sends it to the kernel
        assert ca.plain_reason(_mod(512), _Card(q), kv_r, kv_u) is None
    monkeypatch.setattr(ca, "plain_reason", lambda *args: None)
    before = dict(profiling.COUNTS)
    with torch.no_grad(), pytest.raises(ValueError, match=want):
        ca.grouped_cross_attend(_mod(512), q, kv_r, kv_u, *masks, real,
                                r_idx, u_idx)
    assert profiling.COUNTS == before


@pytest.mark.parametrize("real", [(), (6, 2), (2, 7), (2, 2, 6)])
def test_unsupported_branch_tables(real):
    q, kv_r, kv_u, masks = _valid()
    assert "real branches" in ca.unsupported(q, kv_r, kv_u, *masks, real)


def test_shared_bytes_fit_the_published_streams():
    # D 512: every published Tk fits, and so does Tk 320; 321 does not
    for tk in list(PUBLISHED_TK.values()) + [320]:
        assert ca.shared_bytes(512, (tk, tk)) <= ca.MAX_SHARED_BYTES
    assert ca.shared_bytes(512, (321, 1)) > ca.MAX_SHARED_BYTES
    # at (64, 161): 32 rows of logits of 200 and a mask byte a logit, then
    # q and three K chunks of 520
    assert ca.shared_bytes(512, (64, 161)) == \
        2 * 32 * 200 + 32 * 192 + 2 * 128 * 520
    assert ca.key_padding(1) == 32 and ca.key_padding(161) == 192


def test_ctypes_layout_and_scale():
    # csrc Variant: 3 pointers, 5 int64, 7 int32, 8 branches, padded to 8
    # bytes; Params: 3 pointers, 3 int32, a float and two variants
    assert ctypes.sizeof(ca._CVariant) == 128
    assert ctypes.sizeof(ca._CParams) == 40 + 2 * 128
    assert ca._inv_scale(512) == float(np.float32(1.0) / np.float32(22.625))


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cross-attention kernel runs "
                    "there only")
    return torch.device("cuda")


def _ordered(t):
    """bf16 bit patterns as integers in the order of the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i + 32768), i)


def _compare(got, want, what):
    """Relative RMS of got against want; prints it with the largest gap in
    bf16 ulps."""
    g, w = got.float(), want.float()
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    ulps = int((_ordered(got) - _ordered(want)).abs().max())
    print(f"{what}: rel RMS {rel:.3g}, max |diff| {float((g - w).abs().max()):.3g}"
          f" ({ulps} bf16 ulps), {int((got != want).sum())} of "
          f"{got.numel()} elements differ")
    assert rel <= CARD_RTOL, (what, rel)
    return rel


CARD_CASES = {
    # (B, Tq, uncond batch, every key of a row padded)
    "published": (32, 16, 1, False),
    "b1": (1, 16, 1, False),
    "b96": (96, 16, 1, False),
    "raw_motion_tq128": (32, 128, 1, False),
    "uncond_batch_b": (32, 16, 32, False),
    "padded_rows": (32, 16, 1, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stream", COND_STREAMS)
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_kernel_against_plain(card, case, stream):
    b, tq, unc_batch, padded = CARD_CASES[case]
    tk = PUBLISHED_TK[stream]
    q, kv_r, kv_u, masks = _inputs(b, tq, 512, tk, unc_batch,
                                   masked=stream in MASKED or padded,
                                   device=card, seed=len(case) + tk)
    mod = _mod(512, device=card)
    r_idx, u_idx = _indices(stream, card)
    with torch.no_grad():
        assert ca.plain_reason(mod, q, kv_r, kv_u) is None
        launches = profiling.COUNTS["cross_attend.launches"]
        got = ca.grouped_cross_attend(mod, q, kv_r, kv_u, *masks,
                                      REAL_BRANCHES[stream], r_idx, u_idx)
        assert profiling.COUNTS["cross_attend.launches"] == launches + 1
        want = ca.cross_attend_reference(mod, q, kv_r, kv_u, *masks, r_idx,
                                         u_idx)
    torch.cuda.synchronize()
    _compare(got[0], want[0], f"{case} {stream} out")
    _compare(got[1], want[1], f"{case} {stream} weights")


@pytest.mark.cuda
def test_card_call_the_kernel_cannot_take_raises(card):
    """bf16, grad off, on the card, at D 96: no reason of the rule, so the
    kernel route raises, and no plain call is counted."""
    q, kv_r, kv_u, masks = _inputs(2, 16, 96, 8, 1, masked=True,
                                   device=card)
    mod = _mod(96, device=card)
    r_idx, u_idx = _indices("alsn", card)
    plain = profiling.COUNTS["cross_attend.plain"]
    with torch.no_grad(), pytest.raises(ValueError, match="D 96"):
        ca.grouped_cross_attend(mod, q, kv_r, kv_u, *masks,
                                REAL_BRANCHES["alsn"], r_idx, u_idx)
    assert profiling.COUNTS["cross_attend.plain"] == plain


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(card):
    q, kv_r, kv_u, masks = _inputs(32, 16, 512, 161, 1, masked=True,
                                   device=card)
    real = REAL_BRANCHES["alsn"]
    static = [q.clone(), tuple(t.clone() for t in kv_r)]
    with torch.no_grad():
        graph, (out, att) = _capture(
            lambda: ca.cross_attend(static[0], static[1], kv_u, *masks,
                                    real), card)
        for seed in (1, 2):
            q2, kv2, _, _ = _inputs(32, 16, 512, 161, 1, masked=False,
                                    device=card, seed=seed)
            static[0].copy_(q2)
            for s, t in zip(static[1], kv2):
                s.copy_(t)
            launches = profiling.COUNTS["cross_attend.launches"]
            graph.replay()
            eager = ca.cross_attend(q2, kv2, kv_u, *masks, real)
            torch.cuda.synchronize()
            assert torch.equal(out, eager[0]) and torch.equal(att, eager[1])
            assert profiling.COUNTS["cross_attend.launches"] == launches + 1


def _capture(fn, device):
    from convofusion_tpu_torch.utils import cuda_graphs

    return cuda_graphs.GraphPool().capture(fn, device)


@pytest.mark.cuda
def test_card_guided_denoiser_counts(card):
    """A production-geometry guided denoiser in bf16: 45 launches at a
    capture's warm-up and 45 in the capture, none on a replay, no plain
    call; the replay bit-equal to an eager call; fp32 and grad-enabled
    calls on the card take the plain version and count it."""
    from convofusion_tpu_torch.config import PRODUCTION
    from convofusion_tpu_torch.models.denoiser import Denoiser

    den = Denoiser(latent_dim=128, **PRODUCTION["denoiser"],
                   dtype=BF16).to(card).eval()
    gen = torch.Generator(device=card).manual_seed(0)
    b = 32

    def cond(batch):
        return {s: torch.randn(batch, PUBLISHED_TK[s], 512, generator=gen,
                               device=card).to(BF16) for s in COND_STREAMS}

    real, unc = cond(b), cond(1)
    masks_r = {s: torch.rand(b, PUBLISHED_TK[s], generator=gen,
                             device=card) < 0.3 for s in MASKED}
    masks_u = {s: torch.zeros(1, PUBLISHED_TK[s], dtype=torch.bool,
                              device=card) for s in MASKED}
    lat = torch.randn(b, 16, 128, generator=gen, device=card)
    t = torch.tensor(500, device=card)
    n = len(den.decoder.layers) * len(COND_STREAMS)

    def counts():
        return (profiling.COUNTS["cross_attend.launches"],
                profiling.COUNTS["cross_attend.plain"])

    with torch.no_grad():
        before = counts()
        graph, outs = _capture(
            lambda: den.guided(lat, t, real, unc, masks_r, masks_u), card)
        assert counts() == (before[0] + 2 * n, before[1])
        graph.replay()
        eager = den.guided(lat, t, real, unc, masks_r, masks_u)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 3 * n, before[1])
        assert torch.equal(outs[0], eager[0])
        assert all(torch.equal(outs[1][s], eager[1][s]) for s in outs[1])
    with torch.enable_grad():
        den.guided(lat, t, real, unc, masks_r, masks_u)
    assert counts() == (before[0] + 3 * n, before[1] + n)
    with torch.no_grad():
        den.float()
        den.guided(lat, t, {s: c.float() for s, c in real.items()},
                   {s: c.float() for s, c in unc.items()}, masks_r, masks_u)
    assert counts() == (before[0] + 3 * n, before[1] + 2 * n)
