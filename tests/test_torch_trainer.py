"""The port's trainer: AdamW against optax, frozen subtrees, a few
``fit_steps`` against JAX's ``Trainer``, the model after training, and
dropout.

- ``AdamW``'s scalars through ``ops/adamw.py``'s ``clip_by_global_norm``
  and ``adamw_updates`` against
  ``convofusion_tpu.train.trainer.make_optimizer`` (optax) on the same
  gradients, fed identically to both: constant,
  cosine with warmup (first update 0), cosine, and ``GRAD_CLIP`` 0.05,
  updates within 1e-7 (mirrors ``tests/test_optimizer.py``).
- One step leaves the T5 trunk and (stage 2) the VAE bit-identical and
  moves the denoiser and the text projection (mirrors
  ``tests/test_freeze.py``).
- Three ``fit_steps`` against JAX's on the same draws: losses within 1e-4
  relative.  Parameters are not compared after several steps: where a
  gradient is near 0, AdamW's m / sqrt(v) can flip sign between two
  implementations.
"""
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.data import synthetic as jax_synthetic
from convofusion_tpu.train.trainer import Trainer as JaxTrainer
from convofusion_tpu.train.trainer import make_optimizer
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data import synthetic as torch_synthetic
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.ops import adamw
from convofusion_tpu_torch.ops.layers import Dropout
from convofusion_tpu_torch.train.trainer import (
    AdamW,
    Trainer,
    make_optimizer as port_make_optimizer,
    trainable_parameters,
)
from test_torch_train import (
    diffusion_draws,
    jax_model,
    jax_params_from_port,
    port_config,
)

UPDATE_ATOL = 1e-7
FIT_RTOL = 1e-4
SHAPES = {"w": (4, 3), "b": (3,), "k": (2, 5, 7)}

OPTIM_CASES = {
    # name: TRAIN.OPTIM overrides
    "constant": {},
    "cosine_warmup": {"SCHEDULE": "cosine", "WARMUP_STEPS": 2,
                      "DECAY_STEPS": 6, "END_LR_FACTOR": 0.1},
    "cosine": {"SCHEDULE": "cosine", "DECAY_STEPS": 4},
    "grad_clip": {"GRAD_CLIP": 0.05},
}


def _port_optim(over):
    optim = copy.deepcopy(TINY["train"]["optim"])
    optim["lr"] = 1e-4
    optim.update({k.lower(): v for k, v in over.items()})
    return optim


def _update(opt, grads, state, params):
    """optax's updates of ``params`` from the host numbers of
    ``opt.scalars``; advances ``state``."""
    scalars = opt.scalars(state.count)
    state.count += 1
    return adamw.adamw_updates(
        adamw.clip_by_global_norm(grads, opt.grad_clip), state.mu, state.nu,
        params, scalars, opt.weight_decay)


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_adamw_matches_optax(case):
    """Six steps with gradients of varying scale (so clipped and unclipped
    moments part), past the cosine horizon."""
    over = OPTIM_CASES[case]
    cfg = tiny_config("vae")
    for k, v in over.items():
        cfg.TRAIN.OPTIM[k] = v
    ref = make_optimizer(cfg)
    opt = AdamW(_port_optim(over))
    assert opt.schedule(0) == pytest.approx(float(cfg.TRAIN.OPTIM.LR)) \
        or over.get("WARMUP_STEPS")
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    names = sorted(params)
    s_ref = ref.init(params)
    mine = [torch.from_numpy(params[k].copy()) for k in names]
    state = opt.init(mine)
    for step in range(6):
        grads = {k: (rng.standard_normal(s) * 10.0 ** (step - 2)).astype(
            np.float32) for k, s in SHAPES.items()}
        u_ref, s_ref = ref.update(grads, s_ref, params)
        params = optax.apply_updates(params, u_ref)
        u = _update(opt, [torch.from_numpy(grads[k]) for k in names], state,
                    mine)
        torch._foreach_add_(mine, u)
        for k, got in zip(names, u):
            want = np.asarray(u_ref[k])
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=UPDATE_ATOL, err_msg=f"{k}@{step}")
            if step == 0 and over.get("WARMUP_STEPS"):
                assert float(got.abs().max()) == 0.0
        assert state.count == step + 1


def test_unknown_schedule_and_optimizer_raise():
    assert isinstance(port_make_optimizer(TINY), AdamW)
    with pytest.raises(NotImplementedError, match="SCHEDULE"):
        AdamW(_port_optim({"SCHEDULE": "linear"}))
    with pytest.raises(NotImplementedError, match="optimizer"):
        AdamW(_port_optim({"TYPE": "sgd"}))


@pytest.mark.parametrize("scale", [1e-3, 3.0])
def test_global_norm_clip_is_optax(scale):
    """Above the bound g / |g| * c, below it g itself, as optax's
    clip_by_global_norm: within 4 ulps (5e-7 relative; the norm's fp32
    sums run in another order, observed 1.6e-7); not clip_grad_norm_
    (which divides by |g| + 1e-6)."""
    opt = AdamW(_port_optim({"GRAD_CLIP": 0.05}))
    rng = np.random.default_rng(1)
    g = [(rng.standard_normal(s) * scale).astype(np.float32)
         for s in SHAPES.values()]
    ref = optax.clip_by_global_norm(0.05)
    want, _ = ref.update(g, ref.init(None))
    got = adamw.clip_by_global_norm([torch.from_numpy(x) for x in g],
                                    opt.grad_clip)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-7,
                                   atol=0)
        if scale < 1:
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    if scale > 1:
        torch_clip = [torch.from_numpy(x) for x in g]
        torch.nn.utils.clip_grad_norm_(torch_clip, 0.05)
        assert not all(torch.equal(a, b) for a, b in zip(got, torch_clip))


def _stage2(seed=0, **cfg_over):
    cfg = port_config()
    cfg.update(cfg_over)
    m = Convofusion(cfg, device="cpu", seed=seed)
    raw = jax_synthetic.synthetic_raw_batch(5, 4)
    batch, _, _ = torch_synthetic.prepare_arrays(m, raw)
    return m, raw, batch


def _snapshot(model, prefix):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(prefix)}


def test_step_leaves_frozen_subtrees_untouched():
    m, _, batch = _stage2()
    before = {p: _snapshot(m, p) for p in (
        "text_encoder.text_model.", "vae.", "denoiser.",
        "text_encoder.projection.1.")}
    trainer = Trainer(m)
    loss, terms = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and set(terms) == {"inst_loss", "total"}
    after = {p: _snapshot(m, p) for p in before}
    for frozen in ("text_encoder.text_model.", "vae."):
        for n, v in before[frozen].items():
            assert torch.equal(v, after[frozen][n]), n
    for trained in ("denoiser.", "text_encoder.projection.1."):
        assert sum(float((v - after[trained][n]).abs().sum())
                   for n, v in before[trained].items()) > 0.0, trained
    # no optimizer state for frozen parameters
    names = [n for n, _ in trainable_parameters(m, "diffusion")]
    assert len(trainer.state.mu) == len(names)
    assert not any(n.startswith(("vae.", "text_encoder.text_model."))
                   for n in names)
    # the model is back in eval mode with nothing requiring grad
    assert not m.training
    assert not any(p.requires_grad or p.grad is not None
                   for p in m.parameters())


def test_vae_stage_trains_the_vae_and_zero_grads_decay():
    """Stage 1 moves the VAE; a trainable parameter with a zero gradient
    still decays (torch AdamW and optax.adamw both decay it)."""
    m = Convofusion(port_config("vae"), device="cpu", seed=0, stage="vae")
    raw = jax_synthetic.synthetic_raw_batch(6, 3)
    before = _snapshot(m, "vae.")
    trainer = Trainer(m)
    trainer.fit_steps([{"motion": torch.from_numpy(raw["motion_lsn"])}],
                      torch.Generator().manual_seed(1), log_every=1)
    assert all(not torch.equal(v, dict(m.named_parameters())[n])
               for n, v in before.items())
    opt = trainer.optimizer
    p = [torch.ones(3)]
    u = _update(opt, [torch.zeros(3)], opt.init(p), p)
    assert torch.allclose(u[0], torch.full((3,), -1e-4 * 1e-2))


def test_fit_steps_match_jax_trainer():
    """Three stage-2 steps at batch 10 on JAX's key splits (:158-163),
    with log_every=1: the loss history within FIT_RTOL."""
    b = 10
    pm = Convofusion(port_config(), device="cpu", seed=2)
    params = jax_params_from_port(pm)
    jm = jax_model()
    raws = [jax_synthetic.synthetic_raw_batch(20 + i, b) for i in range(3)]
    jbs = [jax_synthetic.prepare_arrays(jm, r)[0] for r in raws]
    tbs = [torch_synthetic.prepare_arrays(pm, r)[0] for r in raws]
    jt = JaxTrainer(jm, jm.cfg)
    key = jax.random.PRNGKey(8)
    _, _, want = jt.fit_steps(params, jt.optimizer.init(params), jbs, key,
                              log_every=1)
    draws, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        draws.append(diffusion_draws(jm, sub, b))
    got = Trainer(pm).fit_steps(tbs, None, log_every=1, draws=draws)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


def test_sample_after_training_is_a_fresh_models():
    """After fit_steps the model samples as a fresh eval model loaded with
    its weights, and its cached sampler re-encodes the uncond branch."""
    m, _, batch = _stage2(seed=3)
    sampler = m.cached_sampler(3)
    gen = torch.Generator().manual_seed(4)
    sampler(batch, gen)
    version = m.weights_version
    hist = Trainer(m).fit_steps([batch] * 2, torch.Generator().manual_seed(5),
                                log_every=2)
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert m.weights_version > version
    fresh = Convofusion(m.cfg, device="cpu", seed=None)
    fresh.load_state_dict(m.state_dict())
    outs = [s(batch, torch.Generator().manual_seed(6))
            for s in (sampler, fresh.cached_sampler(3))]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _denoise(model, batch, seed=0):
    cond, masks = model.encode_conditions(*(batch[k] for k in (
        "spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
        "active_passive_lsn", "lsn_id")))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch["lsn_id"].shape[0], 16, 32)).astype(np.float32))
    with torch.no_grad():
        return model.denoiser(x, torch.tensor([500, 20, 999, 3]), cond,
                              masks)[0]


def test_dropout_only_in_train_mode():
    """With p = 0.1 a train-mode denoiser call differs from eval; with
    p = 0 it is equal; in eval mode p changes nothing, and a Dropout
    returns its input itself (no op launched)."""
    torch.manual_seed(0)
    drop = {"denoiser": {**TINY["denoiser"], "dropout": 0.1},
            "audio_encoder": {**TINY["audio_encoder"], "dropout": 0.1}}
    m, _, batch = _stage2(seed=7, **drop)
    m0, _, _ = _stage2(seed=7)
    assert any(isinstance(x, Dropout) and x.p == 0.1 for x in m.modules())
    ref = _denoise(m0, batch)
    assert torch.equal(_denoise(m, batch), ref)
    m.train()
    m0.train()
    assert not torch.equal(_denoise(m, batch), ref)
    assert torch.equal(_denoise(m0, batch), ref)
    x = torch.ones(3)
    assert Dropout(0.5).eval()(x) is x and Dropout(0.0).train()(x) is x
