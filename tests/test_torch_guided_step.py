"""The port's plain fused-step version (what ``guided_step`` runs on CPU
tensors) against the JAX Pallas kernel in interpret mode and against the
JAX ``DiffusionScheduler.step`` on the combined epsilon.  Mirrors
tests/test_pallas_step.py; tolerance 2e-5 as there (fp32 element-wise
math, XLA vs PyTorch rounding of the same expressions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convofusion_tpu.diffusion.schedulers import DiffusionScheduler
from convofusion_tpu.ops.pallas_step import fused_guided_step
from convofusion_tpu_torch.diffusion.schedulers import (
    DiffusionScheduler as PortScheduler,
)
from convofusion_tpu_torch.ops.guided_step import (
    guided_step,
    guided_step_reference,
)

TOL = 2e-5
ACP = DiffusionScheduler().alphas_cumprod


def _data(seed, b=2, t=16, d=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((7, b, t, d), (b, t, d), (b, t, d)))


CASES = {
    # name: (alpha_t, alpha_prev, is_ddpm, add_noise)
    "ddpm_mid": (ACP[500], ACP[480], 1.0, 1.0),
    "ddim": (ACP[500], ACP[480], 0.0, 1.0),
    "ddpm_final": (ACP[0], 1.0, 1.0, 0.0),
    "ddim_first": (ACP[980], ACP[960], 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_interpret(case):
    np7, lat, noise = _data(0)
    a_t, a_prev, is_ddpm, add_noise = CASES[case]
    scalars = (float(a_t), float(a_prev), 7.5, is_ddpm, add_noise, 1.0)
    want = fused_guided_step(jnp.asarray(np7), jnp.asarray(lat),
                             jnp.asarray(noise),
                             *map(jnp.float32, scalars), interpret=True)
    got = guided_step_reference(torch.from_numpy(np7), torch.from_numpy(lat),
                                torch.from_numpy(noise), *scalars)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    # the wrapper takes the plain version for CPU tensors
    wrapped = guided_step(torch.from_numpy(np7), torch.from_numpy(lat),
                          torch.from_numpy(noise), *scalars)
    assert torch.equal(wrapped, got)


def test_reference_matches_scheduler_step():
    """Ties the fused step to the production scheduler (JAX and port)."""
    np7, lat, noise = _data(1)
    eps = np7[0] + 7.5 * (np7[1:6].sum(axis=0) - 5.0 * np7[0])
    t, pt = 500, 480
    for variant, is_ddpm in (("ddpm", 1.0), ("ddim", 0.0)):
        want, _ = DiffusionScheduler(variant=variant, clip_sample=True).step(
            jnp.asarray(eps), t, pt, jnp.asarray(lat),
            noise=jnp.asarray(noise))
        port, _ = PortScheduler(variant=variant, clip_sample=True).step(
            torch.from_numpy(eps), t, pt, torch.from_numpy(lat),
            noise=torch.from_numpy(noise))
        got = guided_step_reference(
            torch.from_numpy(np7), torch.from_numpy(lat),
            torch.from_numpy(noise), float(ACP[t]), float(ACP[pt]), 7.5,
            is_ddpm, 1.0, 1.0)
        for out in (got, port):
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)

    # final step: prev_t < 0 -> alpha_prev = 1, no noise
    want, _ = DiffusionScheduler(variant="ddpm").step(
        jnp.asarray(eps), 0, -1, jnp.asarray(lat), noise=jnp.asarray(noise))
    got = guided_step_reference(
        torch.from_numpy(np7), torch.from_numpy(lat), torch.from_numpy(noise),
        float(ACP[0]), 1.0, 7.5, 1.0, 0.0, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_bf16_branches_are_upcast():
    """bf16 noise_pred is read as its exact fp32 value; the output stays
    fp32 like the latents."""
    np7, lat, noise = _data(2)
    np7_bf16 = torch.from_numpy(np7).bfloat16()
    args = (torch.from_numpy(lat), torch.from_numpy(noise), float(ACP[500]),
            float(ACP[480]), 7.5, 1.0, 1.0, 1.0)
    got = guided_step_reference(np7_bf16, *args)
    assert got.dtype == torch.float32
    assert torch.equal(got, guided_step_reference(np7_bf16.float(), *args))


def test_wrapper_rejects_other_devices():
    np7, lat, noise = (torch.from_numpy(a) for a in _data(3))
    with pytest.raises(ValueError):
        guided_step(np7.to("meta"), lat.to("meta"), noise.to("meta"),
                    0.5, 0.6, 7.5, 1.0, 1.0, 1.0)
