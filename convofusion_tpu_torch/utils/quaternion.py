"""Quaternion math (wxyz convention).

Port of ``convofusion_tpu/utils/quaternion.py``: torch versions of the
``jnp`` functions (``qnormalize``, ``qinv``, ``qmul``, ``qrot``,
``qbetween``, :13-54), which broadcast over leading axes and run on the
tensors' device, and numpy copies of the host functions (``qfix_np``,
``qrot_np``, ``qbetween_np``, :57-85) that the data pipeline calls per
sample (reference convofusion/data/beat_dnd/utils/quaternion.py).
"""
from __future__ import annotations

import numpy as np
import torch


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of unit quaternion(s): the conjugate."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r, shapes (*, 4)."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (*, 3) by quaternion(s) q (*, 4)."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion rotating v0 onto v1 (shortest arc)."""
    v = _cross(v0, v1)
    w = torch.sqrt((v0 ** 2).sum(-1, keepdim=True)
                   * (v1 ** 2).sum(-1, keepdim=True)) \
        + (v0 * v1).sum(-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def qfix_np(q: np.ndarray) -> np.ndarray:
    """Sign continuity along the time axis of (L, J, 4) quaternions."""
    result = q.copy()
    dots = np.sum(q[1:] * q[:-1], axis=-1)
    flip = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    result[1:][flip] *= -1
    return result


def qrot_np(q, v):
    """``qrot`` on host numpy (fp32)."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween_np(v0, v1):
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v = np.cross(v0, v1)
    w = np.sqrt(
        (v0**2).sum(axis=-1, keepdims=True)
        * (v1**2).sum(axis=-1, keepdims=True)
    ) + (v0 * v1).sum(axis=-1, keepdims=True)
    q = np.concatenate([w, v], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)
