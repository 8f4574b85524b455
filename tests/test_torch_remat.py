"""Per-layer rematerialisation (``TPU.REMAT``, ``remat=True``) in the
PyTorch port: a trade of memory for a second forward, with the same
numbers.  Mirrors tests/test_remat.py for the standard and the fused
layouts.

- against the same model without remat, on the CPU in fp32: the forward,
  every gradient and the state dict bit-equal, and each layer's forward
  run twice (the recompute) in a training step and once when sampling;
- a stage-2 training step with dropout 0.1 bit-equal to the step without
  remat, the loss generator's final state included: the recompute draws
  the forward's masks from a copy of the generator (``ops/layers.
  checkpointed``), as flax's ``nn.remat`` redraws them from the key;
- the gradients of JAX's remat denoiser (``remat=True``) on the same
  weights, within 1e-5 (fp32 sums in another order).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.compat import torch_loader as tl
from convofusion_tpu.models.denoiser import Denoiser as JaxDenoiser
from convofusion_tpu.ops import fused_streams as jax_fused
from convofusion_tpu_torch.compat import from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.models.denoiser import Denoiser
from convofusion_tpu_torch.ops import transformer as port_transformer
from convofusion_tpu_torch.ops.fused_streams import fuse_denoiser_params
from convofusion_tpu_torch.ops.layers import init_weights
from convofusion_tpu_torch.ops.transformer import COND_STREAMS
from convofusion_tpu_torch.train.trainer import Trainer

D, LAT, B = 64, 32, 2
JAX_GRAD_TOL = 1e-5
SIZES = dict(spkemb=9, alsn=12, tlsn=7, apb=8, lsnemb=1)
LAYOUTS = pytest.mark.parametrize("fuse", [False, True],
                                  ids=["standard", "fused"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _denoiser(fuse, remat, dropout=0.0):
    den = Denoiser(latent_dim=LAT, **{**TINY["denoiser"], "dropout": dropout,
                                      "fuse_streams": fuse, "remat": remat})
    init_weights(den, torch.Generator().manual_seed(0))
    return den


def _inputs():
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((B, 16, LAT)).astype(np.float32)
    cond = {s: rng.standard_normal((B, SIZES[s], D)).astype(np.float32)
            for s in COND_STREAMS}
    pad = np.zeros((B, SIZES["tlsn"]), bool)
    pad[0, 5:] = True
    return sample, cond, {"tlsn": pad}


def _count_layer_calls(module):
    """A list that gets one entry per decoder-layer forward."""
    calls = []
    for layer in module.decoder.layers:
        layer.register_forward_pre_hook(lambda *_: calls.append(1))
    return calls


def _grads(den, sample, cond, masks):
    den.train()
    out, _ = den(torch.from_numpy(sample), 500,
                 {k: torch.from_numpy(v) for k, v in cond.items()},
                 {k: torch.from_numpy(v) for k, v in masks.items()})
    loss = (out ** 2).mean()
    loss.backward()
    return out.detach(), {n: p.grad for n, p in den.named_parameters()}


@LAYOUTS
def test_remat_forward_and_grads_equal_plain(fuse):
    sample, cond, masks = _inputs()
    base, rmt = _denoiser(fuse, False), _denoiser(fuse, True)
    sd_b, sd_r = base.state_dict(), rmt.state_dict()
    assert list(sd_b) == list(sd_r)
    assert all(torch.equal(sd_b[k], sd_r[k]) for k in sd_b)
    calls = _count_layer_calls(rmt)
    out_b, g_b = _grads(base, sample, cond, masks)
    out_r, g_r = _grads(rmt, sample, cond, masks)
    assert len(calls) == 2 * len(rmt.decoder.layers)   # forward + recompute
    assert torch.equal(out_b, out_r)
    assert set(g_b) == set(g_r)
    for k in g_b:
        assert torch.equal(g_b[k], g_r[k]), k


def _stage2(fuse, remat):
    cfg = copy.deepcopy(TINY)
    cfg["denoiser"].update(dropout=0.1, fuse_streams=fuse, remat=remat)
    return Convofusion(cfg, device="cpu", seed=0)


@LAYOUTS
def test_remat_dropout_step_is_bit_equal(fuse):
    """A stage-2 step with dropout 0.1 in the denoiser: loss, every
    gradient and the generator's final state equal without and with
    remat."""
    raw = torch_synthetic.synthetic_raw_batch(0, 4)
    out = {}
    for remat in (False, True):
        model = _stage2(fuse, remat)
        batch, _, _ = torch_synthetic.prepare_arrays(model, raw)
        trainer = Trainer(model)
        calls = _count_layer_calls(model.denoiser)
        gen = torch.Generator().manual_seed(5)
        with trainer.training():
            loss, _ = trainer.compute_grads(batch, gen)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        out[remat] = (loss, grads, gen.get_state(), len(calls))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = out[False], out[True]
    assert c1 == 2 * c0
    assert torch.equal(l0, l1)
    assert torch.equal(s0, s1)
    assert set(g0) == set(g1) and len(g0) > 0
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@LAYOUTS
def test_remat_grads_match_jax(fuse):
    """The port's remat gradients against JAX's ``Denoiser(remat=True)``'s
    (tests/test_remat.py's loss, at dropout 0) on the same weights."""
    sample, cond, masks = _inputs()
    plain = _denoiser(False, False).state_dict()
    den = _denoiser(fuse, True)
    den.load_state_dict(fuse_denoiser_params(plain) if fuse else plain)
    _, g_port = _grads(den, sample, cond, masks)

    sd = {k: v.numpy() for k, v in plain.items()}
    params = tl.denoiser_params(sd, D, 3)
    if fuse:
        params = jax_fused.fuse_denoiser_params(params)
    jd = JaxDenoiser(nfeats=189, latent_dim=LAT, ff_size=64, num_layers=3,
                     num_heads=4, dropout=0.0, text_encoded_dim=D,
                     audio_encoded_dim=D, fuse_streams=fuse, remat=True)

    def loss(p):
        out, _ = jd.apply({"params": p}, sample, jnp.asarray(500), cond,
                          masks)
        return jnp.mean(out ** 2)

    g_jax = jax.jit(jax.grad(loss))(params)
    conv = from_jax._Converter(from_jax._flatten({"denoiser": g_jax}))
    conv.denoiser()
    want = {k[len("denoiser."):]: v for k, v in conv.sd.items()}
    assert set(want) == set(g_port)
    for k, w in want.items():
        np.testing.assert_allclose(g_port[k].numpy(), w.numpy(),
                                   atol=JAX_GRAD_TOL, rtol=0, err_msg=k)


@LAYOUTS
def test_remat_sampling_runs_no_recompute(fuse, monkeypatch):
    """Sampling, WEG's gradient pass included, runs each layer once: the
    checkpoint engages only in a training forward."""
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=2)
    cfg["denoiser"].update(fuse_streams=fuse, remat=True)
    model = Convofusion(cfg, device="cpu", seed=0)
    used = []
    monkeypatch.setattr(port_transformer, "checkpointed",
                        lambda *a: used.append(1))
    raw = torch_synthetic.synthetic_raw_batch(1, B)
    batch, _, _ = torch_synthetic.prepare_arrays(model, raw)
    focus = {"focus_idx": np.array([[1, 2], [1, 0]], np.int32),
             "focus_valid": np.array([[True, True], [True, False]])}
    motion, _ = model.sample(batch, torch.Generator().manual_seed(0), 2,
                             focus=focus)
    assert used == [] and torch.isfinite(motion).all()
