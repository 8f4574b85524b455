"""Training progress callback.

A copy of ``convofusion_tpu/callback/progress.py:13-46`` (reference
convofusion/callback/progress.py, ``ProgressLogger``): each epoch, the
monitored metrics and the host's RAM use, read from /proc/meminfo (psutil
may be absent).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional


def host_memory_percent() -> Optional[float]:
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0])
        total = info["MemTotal"]
        avail = info.get("MemAvailable", info.get("MemFree", 0))
        return 100.0 * (total - avail) / total
    except Exception:
        return None


class ProgressLogger:
    """Epoch-end metric printer (the host analogue of the PL callback)."""

    def __init__(self, logger: Optional[logging.Logger] = None,
                 metric_monitor: Optional[Dict[str, str]] = None):
        self.logger = logger or logging.getLogger("convofusion_tpu_torch")
        # display name -> metric key, like the reference's metric_monitor
        self.metric_monitor = metric_monitor or {}

    def on_epoch_end(self, epoch: int, metrics: Dict[str, float]):
        parts = [f"Epoch {epoch}"]
        monitor = self.metric_monitor or {k: k for k in metrics}
        for display, key in monitor.items():
            if key in metrics:
                parts.append(f"{display}: {float(metrics[key]):.4f}")
        ram = host_memory_percent()
        if ram is not None:
            parts.append(f"RAM: {ram:.1f}%")
        self.logger.info("   ".join(parts))
