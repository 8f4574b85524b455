"""Whole calls captured as CUDA graphs and replayed: what the guided
denoiser's graphs (``models/denoiser.GuidedGraphs``) and the training
step's (``train/step_graphs.StepGraphs``) share.

A capture records a call's kernels once; each replay launches them all
with one host call, so a call of thousands of small kernels no longer
waits on the host's dispatch of each.  Captures run on a side stream of
their pool and allocate from the pool's private memory; graphs that
share a pool must replay one after another, never concurrently.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

# device types a call is captured on; elsewhere it runs eagerly
CAPTURE_DEVICES = ("cuda",)


class GraphPool:
    """One memory pool and one side stream per device for a set of graphs:
    the eager warm-up a capture needs and the capture itself run on the
    side stream, ordered after the current stream's earlier work."""

    def __init__(self):
        self._handle = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _side(self, device) -> torch.cuda.Stream:
        device = torch.device(device)
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        return side

    def run(self, fn: Callable, device):
        """``fn()`` eagerly on the side stream, with the current stream's
        later work ordered after it: a warm-up that is also real work,
        such as a training step's first run."""
        side = self._side(device)
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream(device).wait_stream(side)
        return out

    def capture(self, fn: Callable, device, warmup: bool = True,
                generators: Sequence[torch.Generator] = ()):
        """``fn()`` as one CUDA graph in the pool, after one eager call on
        the side stream if ``warmup``; returns (graph, the outputs each
        replay rewrites).  Each of ``generators`` is registered with the
        graph, so that a replay draws from it what an eager call would at
        its state then, and advances it as far (the device's default
        generator always is).  ``thread_local``: other threads may use the
        card meanwhile."""
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        side = self._side(device)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        if warmup:
            with torch.cuda.stream(side):
                fn()
        with torch.cuda.graph(graph, pool=self._handle, stream=side,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out
