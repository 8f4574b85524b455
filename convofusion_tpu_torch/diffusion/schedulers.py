"""DDPM / DDIM / DPM-Solver++ (2M) schedulers with diffusers-compatible
semantics.

Port of ``convofusion_tpu/diffusion/schedulers.py:26-258``: the beta
schedule, the fp32 ``alphas_cumprod`` table, ``add_noise`` / ``velocity``,
'leading' timestep spacing, the plain ``step`` for DDPM (fixed_small
variance) and DDIM (eta), ``dpmpp_2m_step`` and ``pred_original_sample``.
Tables are numpy; per-step scalars are fp32 CPU tensors (0-dim for a scalar
timestep), so the coefficient arithmetic runs in fp32 as it does in JAX and
never reads the card.  Per-sample timesteps, a (B,) tensor, gather from a
copy of the table on the samples' device (made once a device and kept by
the scheduler), with no trip to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)
        f = np.cos((t / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2
        f_next = np.cos(
            ((t + 1) / num_train_timesteps + 0.008) / 1.008 * np.pi / 2
        ) ** 2
        return np.clip(1.0 - f_next / f, 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionScheduler:
    """Stateless scheduler over numpy tables.  ``variant`` 'ddpm' mirrors
    diffusers.DDPMScheduler.step (fixed_small), 'ddim' DDIMScheduler.step
    with ``eta``."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"  # or "sample"
    variant: str = "ddpm"
    eta: float = 0.0
    # (table name, device) -> the fp32 table there; see `table`
    _device_tables: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        betas = make_beta_schedule(
            self.num_train_timesteps, self.beta_start, self.beta_end,
            self.beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        object.__setattr__(self, "betas", betas.astype(np.float32))
        object.__setattr__(
            self, "alphas_cumprod", alphas_cumprod.astype(np.float32))

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def table(self, name: str, device) -> torch.Tensor:
        """The fp32 ``alphas_cumprod`` or ``betas`` table as a tensor on
        ``device``, copied there once."""
        key = (name, torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = torch.from_numpy(
                getattr(self, name)).to(key[1])
        return self._device_tables[key]

    def gather(self, name: str, timesteps: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
        """``table(name)[timesteps]`` on ``like``'s device, shaped
        (B, 1, ...) to broadcast against it."""
        t = timesteps.to(like.device).long()
        vals = self.table(name, like.device)[t]
        return vals.reshape((-1,) + (1,) * (like.ndim - 1))

    def _sqrt_acps(self, timesteps, samples):
        """(sqrt(acp), sqrt(1 - acp)) in fp32: 0-dim CPU tensors for an int
        or 0-dim timestep; for (B,) timesteps, gathered on the samples'
        device and shaped (B, 1, ...)."""
        t = torch.as_tensor(timesteps)
        if t.ndim > 0:
            acp = self.gather("alphas_cumprod", t, samples)
        else:
            acp = torch.from_numpy(self.alphas_cumprod)[t.cpu().long()]
        return acp.sqrt(), (1.0 - acp).sqrt()

    def add_noise(self, samples, noise, timesteps):
        """q(x_t | x_0) (schedulers.py:85-91): timesteps an int or (B,)."""
        sqrt_acp, sqrt_1macp = self._sqrt_acps(timesteps, samples)
        return sqrt_acp * samples + sqrt_1macp * noise

    def velocity(self, samples, noise, timesteps):
        """The v target (schedulers.py:93-98)."""
        sqrt_acp, sqrt_1macp = self._sqrt_acps(timesteps, samples)
        return sqrt_acp * noise - sqrt_1macp * samples

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps ('leading' spacing, diffusers)."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        return (
            (np.arange(num_inference_steps) * step_ratio)
            .round()[::-1]
            .astype(np.int32)
            .copy()
        )

    def prev_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step_ratio = self.num_train_timesteps // num_inference_steps
        return self.timesteps(num_inference_steps) - step_ratio

    def alpha_prods(self, t: int, prev_t: int) -> Tuple[float, float]:
        """(alpha_prod_t, alpha_prod_prev) with alpha_prod_prev = 1 once
        prev_t < 0 (the final step)."""
        acp = self.alphas_cumprod
        return float(acp[t]), (float(acp[prev_t]) if prev_t >= 0 else 1.0)

    def _pred_x0_eps(self, model_output, sample, alpha_prod_t, beta_prod_t):
        if self.prediction_type == "epsilon":
            x0 = (sample - beta_prod_t.sqrt() * model_output) / \
                alpha_prod_t.sqrt()
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - alpha_prod_t.sqrt() * x0) / beta_prod_t.sqrt()
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
            # re-derive epsilon from the clipped x0
            eps = (sample - alpha_prod_t.sqrt() * x0) / beta_prod_t.sqrt()
        return x0, eps

    def step(self, model_output, t: int, prev_t: int, sample,
             noise: Optional[torch.Tensor] = None):
        """One reverse update; returns (prev_sample, pred_original_sample).
        ``noise`` (fresh N(0,1) of sample shape) is required for DDPM and
        for DDIM with eta > 0."""
        # JAX promotes a bf16 output against the fp32 scalars; a 0-dim
        # torch tensor would not, so upcast here (exact)
        model_output = model_output.float()
        a_t, a_prev = self.alpha_prods(t, prev_t)
        alpha_prod_t, alpha_prod_prev = _f32(a_t), _f32(a_prev)
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_prev = 1.0 - alpha_prod_prev

        x0, eps = self._pred_x0_eps(model_output, sample, alpha_prod_t,
                                    beta_prod_t)

        if self.variant == "ddpm":
            current_alpha = alpha_prod_t / alpha_prod_prev
            current_beta = 1.0 - current_alpha
            coef_x0 = alpha_prod_prev.sqrt() * current_beta / beta_prod_t
            coef_xt = current_alpha.sqrt() * beta_prod_prev / beta_prod_t
            mean = coef_x0 * x0 + coef_xt * sample
            variance = (beta_prod_prev / beta_prod_t * current_beta).clamp(
                min=1e-20)
            if noise is None:
                raise ValueError("DDPM step requires noise")
            std = variance.sqrt() if t > 0 else _f32(0.0)
            return mean + std * noise, x0

        if self.variant == "ddim":
            variance = (beta_prod_prev / beta_prod_t) * (
                1.0 - alpha_prod_t / alpha_prod_prev)
            std = self.eta * variance.sqrt()
            direction = (1.0 - alpha_prod_prev - std**2).clamp(
                min=0.0).sqrt() * eps
            prev = alpha_prod_prev.sqrt() * x0 + direction
            if self.eta > 0.0:
                if noise is None:
                    raise ValueError("eta>0 DDIM step requires noise")
                prev = prev + (std if t > 0 else _f32(0.0)) * noise
            return prev, x0

        raise ValueError(f"unknown scheduler variant {self.variant}")

    # --- DPM-Solver++ (2M), data-prediction multistep (:194-233) ---------
    @staticmethod
    def _lambda(acp_t: torch.Tensor) -> torch.Tensor:
        alpha = acp_t.sqrt()
        sigma = (1.0 - acp_t).sqrt()
        return alpha.clamp(min=1e-20).log() - sigma.clamp(min=1e-20).log()

    def dpmpp_2m_step(self, model_output, t: int, prev_t: int, sample,
                      prev_d, prev_lambda, is_first: bool):
        """One DPM-Solver++ 2M update carrying (prev_d, prev_lambda) across
        steps; the first step takes the first-order update (d = x0), and
        the final one (prev_t < 0) returns x0 exactly.  Every scalar is a
        0-dim fp32 tensor.  Returns (prev_sample, x0, new_prev_d,
        new_lambda)."""
        model_output = model_output.float()
        a_t, a_prev = self.alpha_prods(t, prev_t)
        acp_t, acp_prev = _f32(a_t), _f32(a_prev)
        x0, _ = self._pred_x0_eps(model_output, sample, acp_t, 1.0 - acp_t)
        lam_t = self._lambda(acp_t)
        if prev_t < 0:
            return x0, x0, x0, lam_t
        h = self._lambda(acp_prev) - lam_t
        sigma_t = (1.0 - acp_t).sqrt()
        sigma_prev = (1.0 - acp_prev).sqrt()
        alpha_prev = acp_prev.sqrt()
        if is_first:
            d = x0
        else:
            # second-order combined data prediction
            h_last = lam_t - torch.as_tensor(prev_lambda, dtype=torch.float32)
            r = h_last / torch.where(h == 0, _f32(1.0), h)
            inv_2r = 1.0 / (2.0 * r.clamp(min=1e-8))
            d = (1.0 + inv_2r) * x0 - inv_2r * prev_d
        prev_sample = (sigma_prev / sigma_t.clamp(min=1e-20)) * sample \
            - alpha_prev * (torch.exp(-h) - 1.0) * d
        return prev_sample, x0, x0, lam_t

    def pred_original_sample(self, model_output, t, sample):
        """x0 prediction only (schedulers.py:235-242).  ``t`` an int, or a
        (B,) tensor of per-sample timesteps (the latent loss's vmap,
        convofusion_tpu/models/convofusion.py:557-559)."""
        t = torch.as_tensor(t)
        if t.ndim > 0:
            acp_t = self.gather("alphas_cumprod", t, sample)
        else:
            acp_t = torch.from_numpy(self.alphas_cumprod)[t.cpu().long()]
        x0, _ = self._pred_x0_eps(model_output.float(), sample, acp_t,
                                  1.0 - acp_t)
        return x0


def scheduler_from_config(params: dict, predict_epsilon: bool = True
                          ) -> DiffusionScheduler:
    """Build from a ``config.PRODUCTION['scheduler']``-style dict; a block
    without ``variant`` / ``eta`` (``noise_scheduler``) is DDPM, eta 0
    (convofusion_tpu/models/convofusion.py:156-167)."""
    return DiffusionScheduler(
        num_train_timesteps=int(params["num_train_timesteps"]),
        beta_start=float(params["beta_start"]),
        beta_end=float(params["beta_end"]),
        beta_schedule=str(params["beta_schedule"]),
        clip_sample=bool(params["clip_sample"]),
        prediction_type="epsilon" if predict_epsilon else "sample",
        variant=str(params.get("variant", "ddpm")),
        eta=float(params.get("eta", 0.0)),
    )
