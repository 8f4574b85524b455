"""Experiment metric logging.

Port of ``convofusion_tpu/utils/metrics_logger.py:17-82`` (reference
train.py:64-82 loggers with base.py:45-67's epoch-end ``log_dict``): the
reference's metric names, the epoch mean over finite steps, and an
append-only ``<exp>/metrics.jsonl``.  wandb and TensorBoard attach only
when their packages import; neither is required.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def loss2logname(loss: str, split: str) -> str:
    """Reference metric naming (losses/diffvae.py:223-229)."""
    if loss == "total":
        return f"{loss}/{split}"
    loss_type, name = loss.split("_", 1)
    return f"{loss_type}/{name}/{split}"


def aggregate_terms(term_dicts: List[Dict], split: str) -> Dict[str, float]:
    """Mean every loss term over an epoch, skipping non-finite steps like
    the reference's epoch-end collection (base.py:54-55: ``if not
    torch.isnan(value)``).

    ``term_dicts`` holds one dict of 0-dim terms a step, tensors on the
    device or host numbers.  Tensors are stacked on their device and copied
    to the host once for the whole epoch, not once per term per step."""
    if not term_dicts:
        return {}
    keys = list(term_dicts[0])
    first = term_dicts[0][keys[0]]
    if torch.is_tensor(first):
        vals = torch.stack([torch.stack([d[k].float() for k in keys])
                            for d in term_dicts]).cpu().double().numpy()
    else:
        vals = np.asarray([[float(d[k]) for k in keys] for d in term_dicts],
                          np.float64)
    out = {}
    for j, k in enumerate(keys):
        finite = vals[:, j][np.isfinite(vals[:, j])]
        out[loss2logname(k, split)] = float(
            finite.mean() if finite.size else float("nan"))
    return out


class MetricsLogger:
    """``log(metrics, step)`` appends one JSON row ``{"ts", "step",
    **metrics}`` to ``<exp_dir>/<name>.jsonl``, and to wandb (when asked
    and importable) and TensorBoard (when importable)."""

    def __init__(self, exp_dir: str, name: str = "metrics",
                 enable_wandb: bool = False, wandb_project=None,
                 wandb_resume_id=None):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, f"{name}.jsonl")
        self._wandb = None
        if enable_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_project, dir=exp_dir,
                    resume="allow", id=wandb_resume_id)
            except Exception:
                self._wandb = None
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(exp_dir, "tb"))
        except Exception:
            self._tb = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        row = {"ts": time.time(), "step": step,
               **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
