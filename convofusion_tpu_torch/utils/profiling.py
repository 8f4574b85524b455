"""Spans and counters inside the program, and wall-clock timing of
generated batches.

Spans.  ``span(name, **attrs)`` marks a stretch of host work at a layer
boundary (the sampling call, each reverse step, a training step's forward
and backward).  While nothing records and no profiler runs it returns one
shared object that does nothing.  Inside ``recording()`` it records a
:class:`Span` (host nanoseconds on ``time.perf_counter_ns``, the innermost
open span of the same thread as its parent, the attributes).  While
``torch.profiler`` runs it also enters ``record_function(name)``, so the
span lies on the device trace's own clock as a ``user_annotation`` and
each idle gap of the trace can be put down to the span the host was in.

Counters.  ``count(name, n)`` adds to the process-wide ``COUNTS``, always:
``guided_step.launches`` (the step kernel), ``adamw.launches`` (the AdamW
kernel's host launches), ``melspec.native`` and ``melspec.numpy`` (the
path a mel spectrogram took).  ``recording()``
yields a :class:`Record`: the spans, and ``COUNTS``' change over the
recording.  It stays in memory; nothing writes it out.  Nothing turns
recording on but code.  Two tallies stay apart: ``guided_step.shapes`` is
the set of shapes launched with (a coverage check, not a count), and
``Convofusion.weg_counts`` belongs to one model (the service diffs it
batch by batch).

``SampleTimer`` is a copy of ``convofusion_tpu/utils/profiling.py:28-72``,
the ``TEST.COUNT_TIME`` contract of the reference (convofusion.py:192-193,
263-282; base.py:38-39): per-batch times, rolling means per sample at 100
and 1000 batches, dumped to ``times.txt``.  JAX's ``trace`` and
``annotate`` wrap ``jax.profiler`` and have no counterpart here:
``torch.profiler`` is used directly where a profile is taken, and the
spans above annotate it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
# the Record being filled, or None: the one flag a span checks
_RECORD: Optional["Record"] = None
# per thread: the innermost open recorded span
_OPEN = threading.local()
# True while a torch.profiler (or autograd profiler) runs: a plain module
# flag, cheaper to read than torch.autograd._profiler_enabled()
_PROFILER = torch.autograd.profiler


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


@dataclasses.dataclass
class Record:
    """What one ``recording()`` saw: every span opened in it, in the order
    they opened, and the change of each counter that moved."""
    spans: List["Span"] = dataclasses.field(default_factory=list)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def named(self, name: str) -> List["Span"]:
        return [s for s in self.spans if s.name == name]


class Span:
    """A recorded span; ``end_ns`` is None while it is open."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "attrs",
                 "_annotation")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = None
        self.parent: Optional[Span] = None
        self.thread = threading.get_ident()
        self._annotation = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        self.parent = getattr(_OPEN, "span", None)
        _OPEN.span = self
        if _PROFILER._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _OPEN.span = self.parent
        return False


def span(name: str, **attrs):
    """A context manager over a stretch of host work (module docstring)."""
    rec = _RECORD
    if rec is None:
        if not _PROFILER._is_profiler_enabled:
            return _NOOP
        return torch.profiler.record_function(name)
    s = Span(name, attrs)
    rec.spans.append(s)
    return s


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        COUNTS[name] += n


@contextlib.contextmanager
def recording():
    """Spans on; yields the :class:`Record`, whose ``counts`` are filled
    when the block exits.  One recording at a time."""
    global _RECORD
    rec = Record()
    with _LOCK:
        if _RECORD is not None:
            raise RuntimeError("a recording is already running")
        before = dict(COUNTS)
        _RECORD = rec
    try:
        yield rec
    finally:
        with _LOCK:
            _RECORD = None
            rec.counts = {k: v - before.get(k, 0) for k, v in COUNTS.items()
                          if v != before.get(k, 0)}


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
