"""L1 ops of the PyTorch port against their JAX modules, fp32 on CPU, on
weights from the flax ``init`` carried across by the port's converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.ops import attention as jattn
from convofusion_tpu.ops import embeddings as jemb
from convofusion_tpu.ops import positional as jpos
from convofusion_tpu.ops import transformer as jtr
from convofusion_tpu_torch.compat.from_jax import _Converter, _flatten
from convofusion_tpu_torch.ops import embeddings as temb
from convofusion_tpu_torch.ops import positional as tpos
from convofusion_tpu_torch.ops import transformer as ttr
from convofusion_tpu_torch.ops.attention import MultiheadAttention

# fp32 element-wise math and small GEMMs: XLA vs PyTorch CPU rounding
ATOL = 1e-5


def _load(module, params, kind):
    """Carry one flax module's params into ``module`` via the converter
    rule ``kind`` ('mha', 'time_block')."""
    conv = _Converter(_flatten({"m": params}))
    getattr(conv, kind)("m", "m")
    assert conv.used == set(conv.flat), "unconverted flax params"
    module.load_state_dict({k[2:]: v for k, v in conv.sd.items()})
    return module


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_positional_encodings():
    np.testing.assert_array_equal(tpos.sinusoid_table(64, 32),
                                  jpos.sinusoid_table(64, 32))
    x = np.random.default_rng(0).standard_normal((2, 15, 32)).astype(
        np.float32)
    for jmod, tmod in ((jpos.PositionEmbeddingSine1D(32),
                        tpos.PositionEmbeddingSine1D(32)),
                       (jpos.PositionEmbeddingSineBH(32),
                        tpos.PositionEmbeddingSineBH(32))):
        want = jmod.apply({}, jnp.asarray(x))
        _close(tmod(torch.from_numpy(x)), want, 0)


def test_timestep_embedding():
    ts = np.array([0, 1, 20, 480, 999], np.int32)
    want = jemb.get_timestep_embedding(jnp.asarray(ts), 64, True, 0.0)
    got = temb.get_timestep_embedding(torch.from_numpy(ts), 64, True, 0.0)
    # exp of the frequency table differs by an ulp between XLA and
    # PyTorch; times t <= 999 that is ~2e-6 on the sin/cos arguments
    _close(got, want, 5e-6)

    jmod = jemb.TimestepEmbedding(64)
    params = jmod.init(jax.random.PRNGKey(0), want)["params"]
    tmod = temb.TimestepEmbedding(64, 64)
    conv = _Converter(_flatten({"m": params}))
    for lin in ("linear_1", "linear_2"):
        conv.dense(f"m/{lin}", lin)
    tmod.load_state_dict(conv.sd)
    _close(tmod(torch.from_numpy(np.array(want))),
           jmod.apply({"params": params}, want))


def test_multihead_attention_output_and_weights():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 32)).astype(np.float32)
    pad = np.zeros((2, 7), bool)
    pad[0, 4:] = True
    jmod = jattn.MultiheadAttention(32, 4)
    params = jmod.init(jax.random.PRNGKey(1), q, kv, kv, pad)["params"]
    tmod = _load(MultiheadAttention(32, 4), params, "mha")
    out_j, w_j = jmod.apply({"params": params}, q, kv, kv, pad)
    with torch.no_grad():
        out_t, w_t = tmod(torch.from_numpy(q), torch.from_numpy(kv),
                          torch.from_numpy(kv), torch.from_numpy(pad))
    assert w_t.shape == (2, 5, 7)
    _close(out_t, out_j)
    _close(w_t, w_j)
    assert float(w_t[0, :, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("shared", [True, False])
def test_grouped_attend_with_pads(shared):
    """Shared (1, Tk, D) K/V broadcast against the batch, a pad mask, and a
    fully padded row: the -1e9 fill gives uniform weights, not NaN."""
    rng = np.random.default_rng(2)
    g, b, tq, tk, d = 3, 2, 4, 6, 16
    qg = rng.standard_normal((g, b, tq, d)).astype(np.float32)
    nk = 1 if shared else b
    k = rng.standard_normal((nk, tk, d)).astype(np.float32)
    v = rng.standard_normal((nk, tk, d)).astype(np.float32)
    pad = np.zeros((nk, tk), bool)
    pad[0, :] = True                     # fully padded row
    if not shared:
        pad[1, 3:] = True
    jmod = jattn.MultiheadAttention(d, 1)
    params = jmod.init(jax.random.PRNGKey(2), qg[0], qg[0], qg[0])["params"]
    tmod = _load(MultiheadAttention(d, 1), params, "mha")
    out_j, w_j = jmod.apply({"params": params}, jnp.asarray(qg),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
                            method=jmod.grouped_attend)
    out_t, w_t = tmod.grouped_attend(torch.from_numpy(qg),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(pad))
    assert out_t.shape == (g, b, tq, d) and w_t.shape == (g, b, tq, tk)
    assert torch.isfinite(out_t).all()
    _close(out_t, out_j)
    _close(w_t, w_j)
    _close(w_t[:, 0], np.full((g, tq, tk), 1.0 / tk, np.float32))


def test_time_block():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    emb = rng.standard_normal((1, 3, 1, 32)).astype(np.float32)
    jmod = jtr.TimeBlock(32, 0.0)
    params = jmod.init(jax.random.PRNGKey(3), h, emb)["params"]
    tmod = _load(ttr.TimeBlock(32), params, "time_block")
    with torch.no_grad():
        got = tmod(torch.from_numpy(h), torch.from_numpy(emb))
    _close(got, jmod.apply({"params": params}, h, emb))
