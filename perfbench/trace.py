"""One profiled stretch of a run: device busy time, kernel launches, the
kernels that took most time, and the host work behind each idle gap.

``profiled(label, fn, workdir)`` runs ``fn`` under ``torch.profiler``
inside a ``record_function(label)`` that ends in a synchronise, writes the
Chrome trace to ``workdir``, reads it and deletes it.  Times are seconds.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch")
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Covering:
    """The innermost interval of a set that covers a time."""

    def __init__(self, events):
        events = sorted(events, key=lambda e: e[0])
        self.starts = [e[0] for e in events]
        self.events = events

    def at(self, t: float, default: str) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            start, end, name = self.events[j]
            if end >= t:
                return name
        return default


def summarize(trace: Dict, label: str) -> Dict:
    events = trace["traceEvents"]
    window = next(e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == label)
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    device, ops, spans = [], [], []
    kernels = defaultdict(lambda: [0, 0.0])
    launches = 0
    for e in events:
        cat = e.get("cat")
        if "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((max(a, w0), min(a + d, w1)))
            if cat == "kernel":
                k = kernels[e["name"]]
                k[0] += 1
                k[1] += d * 1e-6
        elif cat in ("cuda_runtime", "cuda_driver") and \
                e.get("name") in LAUNCHES and w0 <= a <= w1:
            launches += 1
        elif cat == "cpu_op":
            ops.append((a, a + d, e["name"]))
        elif cat == "user_annotation" and e is not window:
            spans.append((a, a + d, e["name"]))
    busy = _union([iv for iv in device if iv[1] > iv[0]])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = [(a, b) for a, b in zip([w0] + [b for _, b in busy],
                                   [a for a, _ in busy] + [w1]) if b > a]
    ops_at, spans_at = _Covering(ops), _Covering(spans)
    idle = defaultdict(float)
    for a, b in gaps:
        idle[f"{spans_at.at(b, label)}/{ops_at.at(b, 'python')}"] += \
            (b - a) * 1e-6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "launches": launches,
        "kernels": {name: (n, s) for name, (n, s) in kernels.items()},
        "device_ops": [[name[:120], s] for name, (_, s) in top_ops],
        "idle_gaps": [[name[:120], s] for name, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def span(name: str):
    """A benchmark span the profiler records (``record_function``)."""
    from torch.profiler import record_function

    return record_function(name)


def no_span(name: str):
    return contextlib.nullcontext()


def profiled(label: str, fn: Callable[[], None], workdir: str) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    path = os.path.join(workdir, "profile_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return summarize(trace, label)
