"""Gaussian kernel for the word-excitation smoothing.

Copy of ``gaussian_kernel_2d`` from ``convofusion_tpu/ops/smoothing.py:16-27``
(reference ``convofusion/models/operator/gaussian_smoothing.py``).
"""
from __future__ import annotations

import numpy as np


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
