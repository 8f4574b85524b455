"""VAE and diffusion training losses.

Port of ``convofusion_tpu/losses/diffvae.py:1-164`` (reference
``convofusion/models/losses/diffvae.py``), with its weighting quirks:

- recon SmoothL1 with the root channels x10 and the hand/arm channels x5
  (diffvae.py:197-209);
- KL against N(0, 1) (diffvae.py:94-97,231-241);
- Laplace (second-derivative) recon with the same hand/arm weights;
- bone-length variance over time (ddof 1), skipping bones whose parent is
  joint 0 (diffvae.py:304-332);
- diffusion: MSE on the noise (epsilon prediction) or on x0, and the
  optional prior, latent and guided-attention terms (diffvae.py:142-170).

Each function returns 0-dim tensors on the inputs' device; nothing is read
on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# the guided-attention prior covers these streams (diffvae.py:257-301)
GUIDED_ATTENTION_STREAMS = ("alsn", "tlsn")


def _handarm_mask(nfeats: int) -> np.ndarray:
    """Channels scaled x5 in the recon loss (diffvae.py:202,208)."""
    idx = list(range(5 * 3, 13 * 3)) + list(range(23 * 3, nfeats))
    m = np.zeros(nfeats, np.float32)
    m[idx] = 1.0
    return m


def channel_weights(nfeats: int) -> np.ndarray:
    """(2, nfeats): the recon weights (root 10, hand/arm 5, else 1) and the
    Laplace weights (hand/arm 5, else 1)."""
    hm = _handarm_mask(nfeats) > 0
    w = np.ones((2, nfeats), np.float32)
    w[0, :3] = 10.0
    w[:, hm] = 5.0
    return w


def smooth_l1(pred, target, beta: float = 1.0):
    d = pred - target
    ad = d.abs()
    return torch.where(ad < beta, 0.5 * d * d / beta, ad - 0.5 * beta)


def kl_divergence_normal(mu, logvar):
    """KL(N(mu, exp(0.5*logvar)) || N(0,1)), elementwise."""
    return 0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar)


def bone_pairs(bones: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(n, 2) joint pairs of the bones whose parent is not joint 0."""
    return np.asarray([(j1, j2) for j1, j2 in bones if j1 != 0], np.int64)


def bone_length_variance(motion, pairs):
    """Variance over time (ddof 1) of the bone lengths, mean over batch and
    bones.  motion (B, T, J*3); ``pairs`` is ``bone_pairs`` of the
    skeleton as a tensor on the motion's device."""
    b, t, nf = motion.shape
    pts = motion.reshape(b, t, nf // 3, 3)
    d = pts[:, :, pairs[:, 0]] - pts[:, :, pairs[:, 1]]
    lengths = torch.sqrt((d ** 2).sum(dim=-1) + 1e-12)      # (B, T, nb)
    return lengths.var(dim=1, correction=1).mean()


def vae_losses(m_rst, m_ref, mu, logvar, weights, laplace_rst=None,
               laplace_ref=None, pairs=None, lambda_rec: float = 5.0,
               lambda_kl: float = 5.0e-2, lambda_bl: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    """``weights`` is ``channel_weights(nfeats)`` and ``pairs``
    ``bone_pairs(bones)``, tensors on the motion's device (the model keeps
    them as buffers)."""
    rec = (smooth_l1(m_rst, m_ref) * weights[0].to(m_rst.dtype)).mean()
    kl = kl_divergence_normal(mu, logvar).mean()
    out = {"recons_feature": rec, "kl_motion": kl}
    total = lambda_rec * rec + lambda_kl * kl
    if laplace_rst is not None:
        lap = (smooth_l1(laplace_rst, laplace_ref) * weights[1].to(
            laplace_rst.dtype)).mean()
        out["recons_laplace"] = lap
        total = total + lambda_rec * lap
    if pairs is not None and lambda_bl != 0.0:
        bl = bone_length_variance(m_rst, pairs)
        out["bonelen_feature"] = bl
        total = total + lambda_bl * bl
    out["total"] = total
    return out


def diffusion_losses(noise_pred, noise, predict_epsilon: bool = True,
                     pred_x0=None, latent_gt=None, latent_weights=None,
                     lambda_latent: float = 0.0, noise_pred_prior=None,
                     noise_prior=None, lambda_prior: float = 0.0,
                     att_mats: Optional[Dict[str, torch.Tensor]] = None,
                     lambda_guided_attention: float = 0.0
                     ) -> Dict[str, torch.Tensor]:
    main = ((noise_pred - noise) ** 2).mean()
    out = {("inst_loss" if predict_epsilon else "x_loss"): main}
    total = main
    if lambda_prior != 0.0 and noise_pred_prior is not None:
        # MSE on the prior half of the batch-chunked predictions (the
        # JAX package's MLD-lineage semantics, diffvae.py:124-132)
        prior = ((noise_pred_prior - noise_prior) ** 2).mean()
        out["prior_loss"] = prior
        total = total + lambda_prior * prior
    if lambda_guided_attention != 0.0 and att_mats is not None:
        ga = guided_attention_loss(att_mats)
        out["guidedattention_loss"] = ga
        total = total + lambda_guided_attention * ga
    if lambda_latent != 0.0 and pred_x0 is not None:
        lat = smooth_l1(pred_x0, latent_gt)
        if latent_weights is not None:
            lat = latent_weights.reshape(-1, 1, 1) * lat
        lat = lat.mean()
        out["latent_loss"] = lat
        total = total + lambda_latent * lat
    out["total"] = total
    return out


def guided_attention_loss(att_mats: Dict[str, torch.Tensor],
                          sigma: float = 0.35):
    """Diagonal-attention prior over the alsn/tlsn streams; att_mats[s]
    (B, L, Tq, Tk), averaged over the layers."""
    loss = 0.0
    for s in GUIDED_ATTENTION_STREAMS:
        att = att_mats[s].mean(dim=1)                      # (B, Tq, Tk)
        olen, ilen = att.shape[1], att.shape[2]
        dev = att.device
        gx = torch.arange(olen, dtype=torch.float32, device=dev)[:, None] \
            / olen
        gy = torch.arange(ilen, dtype=torch.float32, device=dev)[None, :] \
            / ilen
        ga = 1.0 - torch.exp(-((gy - gx) ** 2) / (2 * sigma ** 2))
        loss = loss + (att * ga[None]).sum()
    return loss / len(GUIDED_ATTENTION_STREAMS)
