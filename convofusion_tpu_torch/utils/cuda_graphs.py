"""Whole calls captured as CUDA graphs and replayed: what the guided
denoiser's graphs (``models/denoiser.GuidedGraphs``) and the training
step's (``train/step_graphs.StepGraphs``) share.

A capture records a call's kernels once; each replay launches them all
with one host call, so a call of thousands of small kernels no longer
waits on the host's dispatch of each.  Captures run on a side stream of
their pool and allocate from the pool's private memory; graphs that
share a pool must replay one after another, never concurrently.

An owner keeps a graph per input geometry (:func:`geometry`) in an
:class:`LRU`; a graph reads its inputs from static tensors
(:func:`static_like`) into which each call copies its own
(:func:`copy_into`).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Sequence

import torch

# device types a call is captured on; elsewhere it runs eagerly
CAPTURE_DEVICES = ("cuda",)
# input geometries an owner keeps captured (the service pads to one; a
# loader's last, short batch is a second one)
CACHE_SIZE = 4


class Eager(Exception):
    """Inputs that a capture cannot take: the call runs eagerly."""


def geometry(tree, device):
    """The key of a nested dict of tensors: each leaf's path, shape and
    dtype, None for None.  Raises :class:`Eager` for a tensor off
    ``device`` or a leaf that is not a tensor (a host array would be moved
    to the card inside the call, which a capture cannot)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return tuple((k, geometry(tree[k], device)) for k in sorted(tree))
    if torch.is_tensor(tree) and tree.device == device:
        return tuple(tree.shape), tree.dtype
    raise Eager


def static_like(tree):
    """``tree`` with each tensor replaced by an empty one like it: a
    graph's static inputs.  Normal tensors even when made under
    ``inference_mode``, so that a later call without it can still copy
    into them."""
    def like(t):
        if isinstance(t, dict):
            return {k: like(v) for k, v in t.items()}
        return None if t is None else torch.empty_like(t)

    with torch.inference_mode(False):
        return like(tree)


def copy_into(dst, src) -> None:
    """``src``'s tensors into ``dst``, a :func:`static_like` of a tree of
    its geometry."""
    if isinstance(src, dict):
        for k, v in src.items():
            copy_into(dst[k], v)
    elif src is not None:
        dst.copy_(src)


class LRU:
    """At most ``CACHE_SIZE`` values by key, least recently used out
    first."""

    def __init__(self):
        self._values: "collections.OrderedDict[Hashable, object]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._values)

    def clear(self) -> None:
        self._values.clear()

    def get(self, key: Hashable, make: Callable[[], object]):
        """The value of ``key``, made by ``make()`` where there is none."""
        value = self._values.pop(key, None)
        if value is None:
            value = make()
        self._values[key] = value
        while len(self._values) > CACHE_SIZE:
            self._values.popitem(last=False)
        return value


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
