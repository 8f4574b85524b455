"""The port's plain fused-step version (what ``guided_step`` runs on CPU
tensors) against the JAX Pallas kernel in interpret mode and against the
JAX ``DiffusionScheduler.step`` on the combined epsilon.  Mirrors
tests/test_pallas_step.py; tolerance 2e-5 as there (fp32 element-wise
math, XLA vs PyTorch rounding of the same expressions, and the port
multiplies by host-made reciprocals where the Pallas kernel divides).
Also the Python around the CUDA kernel that the CPU reaches: the per-step
scalars, the launch geometry and the wrapper's checks."""
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
    ALIGN,
    MAX_SHARED_BYTES,
    PLANES,
    THREADS,
    TILE,
    _check,
    _launch_geometry,
    guided_step,
    guided_step_reference,
    step_coefs,
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_coefs_match_jax_scalars(case):
    """The host-side scalars are the Pallas kernel's scalar expressions
    (pallas_step.py:54-75) in fp32, to the bit; the two reciprocals are
    1 / sqrt in fp32."""
    a_t, a_prev, is_ddpm, add_noise = CASES[case]
    alpha_t, alpha_prev, gs, is_ddpm_, add_noise_, clip = map(
        jnp.float32, (a_t, a_prev, 7.5, is_ddpm, add_noise, 1.0))
    beta_t = 1.0 - alpha_t
    beta_prev = 1.0 - alpha_prev
    sqrt_at = jnp.sqrt(alpha_t)
    sqrt_bt = jnp.sqrt(beta_t)
    current_alpha = alpha_t / alpha_prev
    current_beta = 1.0 - current_alpha
    variance = jnp.maximum(beta_prev / beta_t * current_beta, 1e-20)
    want = dict(
        gs=gs, sqrt_at=sqrt_at, sqrt_bt=sqrt_bt,
        inv_sqrt_at=1.0 / sqrt_at, inv_sqrt_bt=1.0 / sqrt_bt, clip=clip,
        is_ddpm=is_ddpm_,
        coef_x0=jnp.sqrt(alpha_prev) * current_beta / beta_t,
        coef_xt=jnp.sqrt(current_alpha) * beta_prev / beta_t,
        noise_std=add_noise_ * jnp.sqrt(variance),
        sqrt_aprev=jnp.sqrt(alpha_prev),
        sqrt_bprev=jnp.sqrt(jnp.maximum(beta_prev, 0.0)))
    got = step_coefs(a_t, a_prev, 7.5, is_ddpm, add_noise, 1.0)
    for name, value in want.items():
        assert np.float32(getattr(got, name)) == np.float32(value), name
    if case == "ddpm_final":     # alpha_prev = 1: no noise, x0 weight 1
        assert got.noise_std == 0.0 and got.sqrt_bprev == 0.0


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("batch", [1, 2, 96])
@pytest.mark.parametrize("width", [32, 128])
def test_launch_geometry_covers_each_element_once(elem_size, batch, width):
    """Every element of planes 0-5, the latents and the noise is copied by
    exactly one block, every copy is 16-byte aligned at both ends and
    sized in 16-byte units, and a block's copies fit its shared memory
    without overlapping."""
    n = batch * 16 * width
    geom = _launch_geometry(n, elem_size, TILE[elem_size], THREADS)
    assert (geom.blocks - 1) * geom.tile < n <= geom.blocks * geom.tile
    assert len(geom.copies) == geom.blocks
    assert geom.shared_bytes <= MAX_SHARED_BYTES
    spans = {"np7": [], "latents": [], "noise": []}
    for block in geom.copies:
        assert [c.source for c in block] == ["np7"] * PLANES + [
            "latents", "noise"]
        shared = sorted((c.shared, c.shared + c.nbytes) for c in block)
        for (_, end), (start, _) in zip(shared, shared[1:]):
            assert end <= start
        assert shared[-1][1] <= geom.shared_bytes
        for c in block:
            assert c.offset % ALIGN == 0 and c.shared % ALIGN == 0
            assert c.nbytes % ALIGN == 0 and c.nbytes > 0
            spans[c.source].append((c.offset, c.offset + c.nbytes))
    sizes = {"np7": PLANES * n * elem_size, "latents": n * 4, "noise": n * 4}
    for source, s in spans.items():
        s.sort()
        assert s[0][0] == 0 and s[-1][1] == sizes[source], source
        for (_, end), (start, _) in zip(s, s[1:]):
            assert end == start, source     # no gap, no overlap
    if (batch, width, elem_size) == (96, 128, 2):
        assert geom.blocks <= 132           # the main path: one wave


def test_check_requires_numel_multiple_of_8():
    """Plane k of a bf16 (7, n) tensor starts at k*n*2 bytes: 16-byte
    aligned for the bulk copies only when n % 8 == 0."""
    def tensors(shape):
        return (torch.zeros((7,) + shape, dtype=torch.bfloat16),
                torch.zeros(shape), torch.zeros(shape))

    _check(*tensors((1, 2, 8)))
    for shape in ((1, 3, 4), (1, 1, 12)):
        with pytest.raises(ValueError, match="multiple of 8"):
            _check(*tensors(shape))
