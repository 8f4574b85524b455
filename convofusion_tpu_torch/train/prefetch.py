"""Background host-to-device input pipeline.

Port of ``convofusion_tpu/train/prefetch.py:24-78``.  The reference
overlaps host data work with GPU compute through DataLoader worker
processes (TRAIN.NUM_WORKERS, data/base.py:85-129); here one prefetch
thread runs the host side of batch N+1 (collate, tokenization, the cache
lookups, the copy to the device) while the device runs step N.  The
datasets hold everything in RAM from their construction, so per-batch host
work is slicing and tokenization, and a thread shares the process's CUDA
context.

Stream ordering on the card: the producer thread issues its work (pinned
host tensors copied with ``non_blocking=True``, cache-miss encodes) on a
side stream of its own and records an event after each item.  The consumer
makes its current stream wait for that event before it receives the item,
so nothing reads a device tensor before its copy has landed, and every
tensor of the item is ``record_stream``-ed on the consumer's stream, so the
caching allocator does not hand its block back to the side stream while
the consumer's work on it is still queued.  The copies then overlap the
consumer's kernels.
"""
from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

_OK, _ERR, _DONE = "ok", "err", "done"


def _tensors(obj):
    """Every tensor inside nested dicts, lists and tuples."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def prefetch(iterable: Iterable, prepare_fn: Optional[Callable] = None,
             depth: int = 2, device=None) -> Iterator:
    """Iterate ``prepare_fn(item)`` for item in ``iterable``, running the
    preparation ``depth`` items ahead in a background thread.

    ``depth <= 0`` disables the thread (plain in-line mapping).
    Exceptions raised by the iterable or ``prepare_fn`` re-raise in the
    consumer at the position they occurred.  With a CUDA ``device`` the
    producer works on a side stream, ordered before the consumer's use as
    the module docstring says."""
    prepare_fn = prepare_fn or (lambda x: x)
    if depth <= 0:
        for item in iterable:
            yield prepare_fn(item)
        return

    device = None if device is None else torch.device(device)
    side = (torch.cuda.Stream(device) if device is not None
            and device.type == "cuda" else None)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def prepare(item):
        if side is None:
            return prepare_fn(item), None
        with torch.cuda.stream(side):
            out = prepare_fn(item)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def producer():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put((_OK, prepare(item)))
            q.put((_DONE, None))
        except BaseException:  # noqa: BLE001 — re-raised consumer-side
            q.put((_ERR, sys.exc_info()))

    thread = threading.Thread(target=producer, daemon=True,
                              name="convofusion-prefetch")
    thread.start()
    try:
        while True:
            tag, payload = q.get()
            if tag is _DONE:
                return
            if tag is _ERR:
                raise payload[1].with_traceback(payload[2])
            out, done = payload
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for t in _tensors(out):
                    if t.device.type == "cuda":
                        t.record_stream(consumer)
            yield out
    finally:
        # the consumer abandoned the iterator (break / exception) or it is
        # exhausted: unblock any pending put and retire the producer.  The
        # drain is bounded: a producer stuck inside prepare_fn (a hung
        # device transfer) cannot be joined, so give up after ~5 s and
        # rely on the daemon flag rather than hang generator close forever
        stop.set()
        for _ in range(50):
            if not thread.is_alive():
                break
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.1)
