"""Wall-clock timing of generated batches.

``SampleTimer`` is a copy of ``convofusion_tpu/utils/profiling.py:28-72``,
the ``TEST.COUNT_TIME`` contract of the reference (convofusion.py:192-193,
263-282; base.py:38-39): per-batch times, rolling means per sample at 100
and 1000 batches, dumped to ``times.txt``.  JAX's ``trace`` and
``annotate`` wrap ``jax.profiler`` and have no counterpart here
(``torch.profiler`` is used directly where a profile is taken).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np


class SampleTimer:
    """Per-batch wall-clock accumulator (reference COUNT_TIME semantics)."""

    def __init__(self, batch_size: int, out_dir: Optional[str] = None,
                 log=print):
        self.batch_size = batch_size
        self.out_dir = out_dir
        self.times: List[float] = []
        self._start = None
        self.log = log

    def start(self):
        self._start = time.time()

    def stop(self):
        assert self._start is not None, "start() not called"
        self.times.append(time.time() - self._start)
        self._start = None
        n = len(self.times)
        if n % 100 == 0:
            mean = np.mean(self.times[-100:]) / self.batch_size
            self.log(f"100 iter mean Time (batch_size: "
                     f"{self.batch_size}): {mean}")
        if n % 1000 == 0:
            mean = np.mean(self.times[-1000:]) / self.batch_size
            self.log(f"1000 iter mean Time (batch_size: "
                     f"{self.batch_size}): {mean}")
            self.dump()

    def mean_per_sample(self) -> float:
        return float(np.mean(self.times)) / self.batch_size \
            if self.times else float("nan")

    def dump(self, path: Optional[str] = None):
        path = path or (os.path.join(self.out_dir, "times.txt")
                        if self.out_dir else None)
        if path:
            with open(path, "w") as f:
                for t in self.times:
                    f.write(f"{t}\n")
        return path
