"""Small convolution helpers: the Gaussian kernel of the word-excitation
smoothing and the 1-D Laplace filter of the VAE's second-derivative
reconstruction loss.

Copies of ``gaussian_kernel_2d``, ``laplacian_1d_kernel`` and
``laplace_filter_time`` from ``convofusion_tpu/ops/smoothing.py:16-73``
(reference ``convofusion/models/operator/gaussian_smoothing.py`` and the
kornia ``laplacian_1d`` kernel).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_2d(kernel_size: int = 3, sigma: float = 0.5) -> np.ndarray:
    """Separable 2-D Gaussian kernel, normalized to sum 1."""
    grid = np.arange(kernel_size, dtype=np.float32)
    mean = (kernel_size - 1) / 2.0
    # the reference divides by (2*sigma) inside the square
    # (gaussian_smoothing.py:40); kept, as the JAX package keeps it
    g = np.exp(-(((grid - mean) / (2.0 * sigma)) ** 2)) / (
        sigma * np.sqrt(2.0 * np.pi)
    )
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def laplacian_1d_kernel(window_size: int) -> np.ndarray:
    """kornia.filters.kernels.laplacian_1d: ones with center = 1 - N."""
    k = np.ones(window_size, dtype=np.float32)
    k[window_size // 2] = 1.0 - window_size
    return k


def laplace_filter_time(motion: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """Valid 1-D Laplace filter along the time axis of (B, T, F) motion,
    one ``F.conv1d`` over the B*F series in the motion's dtype.  ``kernel``
    is ``laplacian_1d_kernel(N)`` as a tensor on the motion's device (the
    model keeps it as a buffer); output (B, T - N + 1, F)."""
    b, t, f = motion.shape
    x = motion.transpose(1, 2).reshape(b * f, 1, t)
    out = F.conv1d(x, kernel.to(motion.dtype)[None, None])
    return out.reshape(b, f, -1).transpose(1, 2)
