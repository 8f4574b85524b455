"""The ablations' modules of the PyTorch port against their JAX twins, fp32,
tiny geometry: the learned PE, the post-norm encoder and decoder layers
(with and without ``pos``), the VAE with ``mlp_dist``, with
``all_encoder`` and with learned PEs and post-norm (encode with a fed eps,
decode), the ``trans_enc`` denoiser for the text, action and text+audio
conditions, the trans_dec denoiser's learned memory PE, ``EmbedAction``
(eval, guided, training with a fed mask) and ``TextAudioController`` in
both modes.

Each JAX module is initialised by flax; ``compat.from_jax.
module_state_dict_from_jax`` carries its tree into the port module; both
take the same numpy inputs.  Tolerance 1e-5 absolute unless a test says
otherwise (one fp32 layer agrees to ~1e-6; stacks of a few layers to a
few 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.models import audioenc as jax_audioenc
from convofusion_tpu.models import denoiser as jax_denoiser
from convofusion_tpu.models import vae as jax_vae
from convofusion_tpu.ops import positional as jax_positional
from convofusion_tpu.ops import transformer as jax_transformer
from convofusion_tpu_torch.compat.from_jax import module_state_dict_from_jax
from convofusion_tpu_torch.models.audioenc import TextAudioController
from convofusion_tpu_torch.models.denoiser import Denoiser, EmbedAction
from convofusion_tpu_torch.models.vae import ConvoFusionVae
from convofusion_tpu_torch.ops.positional import (
    PositionEmbeddingLearned1D,
    build_position_encoding,
)
from convofusion_tpu_torch.ops.transformer import (
    COND_STREAMS,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
)

ATOL = 1e-5
D = 32
TEXT_D = 64
STREAM_LEN = dict(spkemb=9, alsn=12, tlsn=7, apb=8, lsnemb=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(module, kind, params):
    module.load_state_dict(module_state_dict_from_jax(kind, params))
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), rtol=0, atol=atol)


def test_learned_pe():
    x = _rand(0, 2, 11, D)
    jm = jax_positional.PositionEmbeddingLearned1D(D)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert params["pe"].shape == (1024, D)
    assert 0.0 <= float(params["pe"].min()) and float(params["pe"].max()) \
        <= 1.0
    pm = PositionEmbeddingLearned1D(D)
    pm.load_state_dict({"pe": torch.from_numpy(np.asarray(params["pe"]))})
    _close(pm(torch.from_numpy(x)), jm.apply({"params": params},
                                             jnp.asarray(x)))
    assert isinstance(build_position_encoding(D, "v3"),
                      PositionEmbeddingLearned1D)
    with pytest.raises(ValueError, match="position_embedding"):
        build_position_encoding(D, "rotary")
    with pytest.raises(ValueError):
        jax_positional.build_position_encoding(D, "rotary")


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("with_pos", [False, True])
def test_encoder_layer(normalize_before, with_pos):
    src, pos = _rand(1, 2, 10, D), _rand(2, 2, 10, D)
    jm = jax_transformer.TransformerEncoderLayer(
        D, 2, 64, 0.0, "gelu", normalize_before)
    args = (jnp.asarray(src), None, jnp.asarray(pos) if with_pos else None)
    params = jm.init(jax.random.PRNGKey(3), *args)["params"]
    pm = _port(TransformerEncoderLayer(D, 2, 64, "gelu", normalize_before),
               "encoder_layer", params)
    got = pm(torch.from_numpy(src),
             pos=torch.from_numpy(pos) if with_pos else None)
    _close(got, jm.apply({"params": params}, *args))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("with_pos", [False, True])
def test_decoder_layer(normalize_before, with_pos):
    tgt, mem = _rand(4, 2, 12, D), _rand(5, 2, 8, D)
    pos, qpos = _rand(6, 2, 8, D), _rand(7, 2, 12, D)
    jm = jax_transformer.TransformerDecoderLayer(
        D, 2, 64, 0.0, "gelu", normalize_before)
    j_pos = dict(pos=jnp.asarray(pos), query_pos=jnp.asarray(qpos)) \
        if with_pos else {}
    params = jm.init(jax.random.PRNGKey(8), jnp.asarray(tgt),
                     jnp.asarray(mem), **j_pos)["params"]
    pm = _port(TransformerDecoderLayer(D, 2, 64, "gelu", normalize_before),
               "decoder_layer", params)
    t_pos = dict(pos=torch.from_numpy(pos), query_pos=torch.from_numpy(
        qpos)) if with_pos else {}
    got = pm(torch.from_numpy(tgt), torch.from_numpy(mem), **t_pos)
    _close(got, jm.apply({"params": params}, jnp.asarray(tgt),
                         jnp.asarray(mem), **j_pos))


VAE_CASES = {
    "mlp_dist": dict(mlp_dist=True),
    "all_encoder": dict(arch="all_encoder"),
    "learned_post_norm": dict(position_embedding="learned",
                              normalize_before=False),
}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae(case):
    kw = dict(VAE_CASES[case])
    jm = jax_vae.ConvoFusionVae(latent_dim=D, ff_size=64, num_layers=3,
                                num_heads=2, dropout=0.0, **kw)
    motion = _rand(9, 2, 128, 189)
    params = jm.init(jax.random.PRNGKey(10), jnp.asarray(motion))["params"]
    if case == "mlp_dist":
        assert params["body_global_motion_token"].shape == (1, D)
        assert params["body_dist_layer"]["kernel"].shape == (D, 2 * D)
    if case == "all_encoder":
        assert "multihead_attn" not in params["body_decoder"]["middle_block"]
    pm = _port(ConvoFusionVae(latent_dim=D, ff_size=64, num_layers=3,
                              num_heads=2, **kw), "vae", params)
    key = jax.random.PRNGKey(11)
    lat_j, (mu_j, logvar_j), feats_j = jm.apply(
        {"params": params}, jnp.asarray(motion), key, method=jm.encode)
    eps = np.asarray(jax.random.normal(key, mu_j.shape, mu_j.dtype))
    with torch.no_grad():
        lat_p, (mu_p, logvar_p), feats_p = pm.encode(
            torch.from_numpy(motion), eps=torch.from_numpy(eps))
        z = _rand(12, 2, 2, 8, D)
        out_p = pm.decode(torch.from_numpy(z), 128)
    for got, want in ((lat_p, lat_j), (mu_p, mu_j), (logvar_p, logvar_j),
                      (feats_p, feats_j)):
        _close(got, want)
    # two 3-layer skip stacks over 128 (or 136) tokens, outputs of O(1)
    _close(out_p, jm.apply({"params": params}, jnp.asarray(z), 128,
                           method=jm.decode), atol=2e-5)


def _stream_cond(seed, b):
    return {s: _rand(seed + i, b, STREAM_LEN[s], TEXT_D)
            for i, s in enumerate(COND_STREAMS)}


TRANS_ENC_CONDS = {
    "text": lambda b: _rand(20, b, 11, TEXT_D),
    "action": lambda b: np.array([[1], [2], [3], [0]][:b], np.int32),
    "text+audio": lambda b: _stream_cond(30, b),
}


def _to_torch(cond):
    if isinstance(cond, dict):
        return {k: torch.from_numpy(v) for k, v in cond.items()}
    return torch.from_numpy(cond)


@pytest.mark.parametrize("condition", sorted(TRANS_ENC_CONDS))
def test_trans_enc(condition):
    b = 4
    kw = dict(latent_dim=D, ff_size=64, num_layers=3, num_heads=4,
              text_encoded_dim=TEXT_D, arch="trans_enc",
              condition=condition)
    jm = jax_denoiser.Denoiser(dropout=0.0, nclasses=10, **kw)
    sample, cond = _rand(13, b, 16, D), TRANS_ENC_CONDS[condition](b)
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    params = jm.init(jax.random.PRNGKey(14), jnp.asarray(sample),
                     jnp.asarray(100), jcond)["params"]
    assert "decoder" not in params and "condition_embedding" not in params
    pm = _port(Denoiser(**kw), "denoiser", params)
    want, att_j = jm.apply({"params": params}, jnp.asarray(sample),
                           jnp.asarray(100), jcond)
    with torch.no_grad():
        got, att_p = pm(torch.from_numpy(sample), 100, _to_torch(cond))
    assert att_p == {} and att_j == {}
    _close(got, want)
    x = torch.from_numpy(sample)
    for call in (lambda: pm.guided(x, 100, None, None),
                 lambda: pm.text_only(x, 100, None)):
        with pytest.raises(ValueError, match="trans_enc"):
            call()


def test_trans_dec_learned_memory_pe():
    b = 2
    kw = dict(latent_dim=D, ff_size=64, num_layers=3, num_heads=4,
              text_encoded_dim=TEXT_D, position_embedding="learned")
    jm = jax_denoiser.Denoiser(dropout=0.0, **kw)
    sample, cond = _rand(40, b, 16, D), _stream_cond(41, b)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = jm.init(jax.random.PRNGKey(15), jnp.asarray(sample),
                     jnp.asarray(100), jcond)["params"]
    assert params["mem_pos"]["pe"].shape == (1024, TEXT_D)
    pm = _port(Denoiser(**kw), "denoiser", params)
    want, _ = jm.apply({"params": params}, jnp.asarray(sample),
                       jnp.asarray(100), jcond)
    with torch.no_grad():
        got, _ = pm(torch.from_numpy(sample), 100, _to_torch(cond))
    _close(got, want)


@pytest.mark.parametrize("mode", ["eval", "guided", "train"])
def test_embed_action(mode):
    b = 8
    gs = 1.0 if mode == "eval" else 7.5
    jm = jax_denoiser.EmbedAction(num_actions=5, latent_dim=D,
                                  guidance_scale=gs, guidance_uncondp=0.5)
    action = np.array([[i % 5] for i in range(b)], np.int32)
    params = jm.init(jax.random.PRNGKey(16), jnp.asarray(action))["params"]
    pm = _port(EmbedAction(5, D, guidance_scale=gs, guidance_uncondp=0.5),
               "embed_action", params)
    if mode != "train":
        want = jm.apply({"params": params}, jnp.asarray(action))
        got = pm(torch.from_numpy(action))
        if mode == "guided":
            assert not np.asarray(want[: b // 2]).any()
        _close(got, want, atol=0)
        return
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(action),
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(17)}))
    # JAX's Bernoulli draw, read off its output: the rows it zeroed
    drop = ~want[:, 0].any(axis=-1)
    assert 0 < drop.sum() < b
    pm.train()
    got = pm(torch.from_numpy(action), drop=torch.from_numpy(drop))
    _close(got, want, atol=0)
    # without a fed mask, the draw comes from the dropout generator in scope
    from convofusion_tpu_torch.ops.layers import dropout_generator

    outs = []
    for _ in range(2):
        with dropout_generator(torch.Generator().manual_seed(3)):
            outs.append(pm(torch.from_numpy(action)))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("mode", ["spk-ta", "lsn"])
def test_text_audio_controller(mode):
    b, tt = 2, 9
    jm = jax_audioenc.TextAudioController(out_dim=D, text_max_length=20,
                                          audio_max_length=161)
    text_emb, mel = _rand(50, b, tt, D), _rand(51, b, 161, 80)
    text_mask = np.ones((b, tt), bool)
    text_mask[1, 6:] = False
    args = (jnp.asarray(text_emb), jnp.asarray(text_mask), jnp.asarray(mel))
    params = jm.init(jax.random.PRNGKey(18), *args, "spk-ta")["params"]
    pm = _port(TextAudioController(out_dim=D, text_max_length=20,
                                   audio_max_length=161), "controller",
               params)
    want = jm.apply({"params": params}, *args, mode)
    with torch.no_grad():
        got = pm(torch.from_numpy(text_emb), torch.from_numpy(text_mask),
                 torch.from_numpy(mel), mode)
    assert got[2] is None and want[2] is None
    assert torch.equal(got[3], torch.from_numpy(np.asarray(want[3])))
    _close(got[1], want[1], atol=0)
    for g, w in ((got[0], want[0]), (got[4], want[4])):
        if w is None:
            assert g is None
        else:
            assert g.shape == w.shape
            _close(g, w)


def test_denoiser_post_norm_raises_in_both():
    """JAX asserts the trans_dec layers are pre-norm; the port raises."""
    kw = dict(latent_dim=D, ff_size=64, num_layers=3, num_heads=4,
              text_encoded_dim=TEXT_D, normalize_before=False)
    jm = jax_denoiser.Denoiser(dropout=0.0, **kw)
    cond = {k: jnp.asarray(v) for k, v in _stream_cond(60, 2).items()}
    with pytest.raises(AssertionError):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, D)),
                jnp.asarray(1), cond)
    with pytest.raises(ValueError, match="pre-norm"):
        Denoiser(**kw)
    # trans_enc's encoder takes post-norm layers in both
    enc = Denoiser(arch="trans_enc", **kw)
    assert not enc.encoder.middle_block.normalize_before
