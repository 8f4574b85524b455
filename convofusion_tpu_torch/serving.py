"""Online serving: request micro-batching over the cached sampler, and a
stdlib HTTP front end.

Port of ``convofusion_tpu/serving.py:55-565``.

* :class:`GestureService` accepts single generation requests (listener and
  speaker text, mel spectrogram, active/passive bits, listener id, optional
  focus words), groups them into fixed-size micro-batches (the tail padded
  by repeating the last request, so the batch geometry never changes), runs
  them through :meth:`Convofusion.cached_sampler`, and resolves one future a
  request with its (128, nfeats) motion.
* :func:`serve_http` wraps a service in a ``ThreadingHTTPServer``
  (``POST /generate``, ``GET /stats``, ``GET /healthz``).
* :func:`build_service` and :func:`main` (``python -m
  convofusion_tpu_torch.serving``) stand one up from a merged YAML config
  or a port config dict, with a checkpoint's weights or random ones.

The service is a three-stage pipeline with bounded queues between stages:

* the *builder* thread collects requests and does the host work
  (tokenization, numpy batch assembly, focus-word mapping);
* the *device* thread is the only thread that sends work to the card: it
  applies pending weights, copies the batch in, runs the sampler, starts
  the copy of the motion into pinned host memory and records a CUDA event
  behind it;
* the *fetch* thread waits on that event, reads the host copy, resolves the
  futures and accounts the stats.  It never enqueues a copy itself: a copy
  enqueued from it would queue behind whatever the device thread has
  launched since.

All three share the interpreter lock, and the eager step loop is
host-dispatch bound, so the builder's tokenization competes with the
device thread's dispatch.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from convofusion_tpu_torch.config import (
    PRODUCTION,
    TINY,
    from_cfg,
    load_config,
)
from convofusion_tpu_torch.models.convofusion import Convofusion, to_tensors
from convofusion_tpu_torch.models.tokenizer import focus_word_indices
from convofusion_tpu_torch.train.checkpoint import (
    load_torch_full_model,
    maybe_load_t5_assets,
)


def _resolve(fut: Future, value=None, exc=None) -> None:
    """Resolve a request future, tolerating a client-side ``cancel()``:
    ``set_result`` on a cancelled Future raises ``InvalidStateError``,
    which must not poison the rest of the micro-batch."""
    try:
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass  # lost the race with a concurrent cancel()


@dataclass
class GestureRequest:
    """One generation request (the per-sample fields of the reference's
    test batch, BEAT_DnD collate, dataset.py:744-780)."""

    text_lsn: str
    text_spk: str = ""
    melspec: Optional[np.ndarray] = None  # (mel_frames, n_mels) dB
    active_passive: Optional[np.ndarray] = None  # (n_chunks,) in {0,1,2}
    lsn_id: int = 0
    focus_words: Sequence[str] = field(default_factory=tuple)

    @classmethod
    def from_json(cls, obj: Dict) -> "GestureRequest":
        mel = obj.get("melspec")
        apb = obj.get("active_passive")
        return cls(
            text_lsn=str(obj.get("text_lsn", obj.get("text", ""))),
            text_spk=str(obj.get("text_spk", "")),
            melspec=None if mel is None else np.asarray(mel, np.float32),
            active_passive=None if apb is None else np.asarray(apb,
                                                               np.int32),
            lsn_id=int(obj.get("lsn_id", 0)),
            focus_words=tuple(obj.get("focus_words", ())),
        )


class ServiceOverloaded(RuntimeError):
    """Raised by :meth:`GestureService.submit` when the intake queue is at
    ``max_queue``: callers back off and retry; the HTTP front end maps it
    to 503 with Retry-After."""


def _percentile(sorted_values: List[float], p: float) -> float:
    if not sorted_values:
        return float("nan")
    return sorted_values[min(len(sorted_values) - 1,
                             int(p * len(sorted_values)))]


class GestureService:
    """Micro-batching gesture generation service around a
    :class:`Convofusion` model.

    ``batch_size`` fixes the batch geometry; ``max_wait_ms`` bounds the time
    the first request of a batch waits for company.  ``weg`` runs
    word-excitation guidance and honours per-request ``focus_words``
    (requests without focus words get an all-invalid focus mask, a no-op
    refinement).  ``max_queue`` bounds the intake queue (default ``8 *
    batch_size``; ``0`` = unbounded): beyond it, submits raise
    :class:`ServiceOverloaded`.  ``seed`` seeds the ``torch.Generator`` on
    the model's device that the device thread alone draws from."""

    def __init__(self, model: Convofusion, batch_size: int = 8,
                 max_wait_ms: float = 25.0,
                 num_inference_steps: Optional[int] = None,
                 weg: bool = False, weg_max_focus: int = 8, seed: int = 0,
                 max_queue: Optional[int] = None):
        self.model = model
        self.batch_size = int(batch_size)
        self.max_wait = float(max_wait_ms) / 1e3
        self.weg = bool(weg)
        self.weg_max_focus = int(weg_max_focus)
        self.mel_shape = (int(model.cfg["mel_frames"]),
                          int(model.cfg["audio_encoder"]["input_size"]))
        self.n_chunks = model.n_chunks
        self._sampler = model.cached_sampler(
            num_inference_steps=num_inference_steps)
        self._generator = torch.Generator(device=model.device)
        self._generator.manual_seed(int(seed))
        self.max_queue = (8 * self.batch_size if max_queue is None
                          else int(max_queue))
        # weights handed to update_params, applied by the device thread
        self._pending_weights = None
        self._weights_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        # one-slot hand-off: batch N+1 is built while batch N runs
        self._ready: "queue.Queue" = queue.Queue(maxsize=1)
        # dispatched but unfetched batches: bounds the motion in flight
        self._done: "queue.Queue" = queue.Queue(maxsize=2)
        self._stats_lock = threading.Lock()
        # orders submit()'s closed-check + enqueue against close()'s
        # sentinel + drain, so no future slips in behind the drain
        self._submit_lock = threading.Lock()
        self._closed = False
        self.reset_stats()
        self._threads = [
            threading.Thread(target=fn, daemon=True,
                             name=f"gesture-service-{name}")
            for name, fn in (("build", self._run_build),
                             ("device", self._run_device),
                             ("fetch", self._run_fetch))]
        for th in self._threads:
            th.start()

    # ------------------------------------------------------------ client API
    def submit(self, request: GestureRequest) -> Future:
        """Enqueue; the future resolves to motion (128, nfeats) float32."""
        self._validate(request)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            # qsize is exact here: submits are serialized by this lock and
            # the consumer only ever shrinks the queue
            if self.max_queue and self._q.qsize() >= self.max_queue:
                with self._stats_lock:
                    self._n_rejected += 1
                raise ServiceOverloaded(
                    f"intake queue full ({self.max_queue} requests); "
                    f"retry later")
            fut: Future = Future()
            self._q.put((request, fut, time.perf_counter()))
        return fut

    def generate(self, request: GestureRequest,
                 timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(request).result(timeout=timeout)

    def update_params(self, state_dict) -> None:
        """Swap the model's weights (a port ``state_dict``;
        ``compat/from_jax.state_dict_from_jax`` makes one from a JAX
        tree).  The device thread loads them between micro-batches, before
        the next one, and drops the sampler's uncond cache."""
        with self._weights_lock:
            self._pending_weights = state_dict

    def stats(self) -> Dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            batch_ms = sorted(self._batch_ms)
            cap = self._n_batches * self.batch_size
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "rejected": self._n_rejected,
                "queue_depth": self._q.qsize(),
                "occupancy": (self._rows_used / cap) if cap else 0.0,
                "latency_p50_ms": _percentile(lat, 0.50) * 1e3,
                "latency_p95_ms": _percentile(lat, 0.95) * 1e3,
                # from the device thread's start on a batch to its motion
                # on the host
                "batch_ms_p50": _percentile(batch_ms, 0.50),
                "text_only_passes": self._weg[0],
                "refinement_iterations": self._weg[1],
            }

    def reset_stats(self) -> None:
        """Zero the counters and the latency window (e.g. after warm-up)."""
        with self._stats_lock:
            self._n_requests = 0
            self._n_batches = 0
            self._n_rejected = 0
            self._rows_used = 0
            self._latencies: List[float] = []
            self._batch_ms: List[float] = []
            self._weg = [0, 0]

    def close(self, timeout: float = 30.0) -> None:
        """Serve what is queued, stop the pipeline threads, and fail every
        future still held by any stage.

        Requests already queued when the shutdown sentinel lands are still
        served (FIFO).  The drains after the joins catch what a stage that
        died or wedged left behind, so no caller blocks forever on a
        future."""
        if self._closed:
            return
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        for th in self._threads:
            th.join(timeout=timeout)
            if th.is_alive():
                logging.getLogger(__name__).warning(
                    "GestureService.close: %s did not join within %.1fs",
                    th.name, timeout)
        closed = RuntimeError("service closed")
        for item in _drain(self._q):
            _resolve(item[1], exc=closed)
        for q in (self._ready, self._done):
            for item in _drain(q):
                for _, fut, _ in item[-1]:
                    _resolve(fut, exc=closed)

    # --------------------------------------------------------------- stages
    def _validate(self, r: GestureRequest) -> None:
        if r.melspec is not None and tuple(r.melspec.shape) != self.mel_shape:
            raise ValueError(
                f"melspec must be {self.mel_shape}, got {r.melspec.shape}")
        if r.active_passive is not None and \
                tuple(r.active_passive.shape) != (self.n_chunks,):
            raise ValueError(
                f"active_passive must be ({self.n_chunks},), got "
                f"{r.active_passive.shape}")
        if r.focus_words and not self.weg:
            raise ValueError(
                "focus_words given but the service was built with "
                "weg=False")

    def _collect(self) -> Optional[List]:
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the shutdown sentinel
                break
            batch.append(nxt)
        return batch

    def _run_build(self) -> None:
        """Stage 1: collect requests and do all host work; hand the numpy
        batch to the device thread through the one-slot queue."""
        while True:
            batch = self._collect()
            if batch is None:
                self._ready.put(None)
                return
            try:
                arrays, focus = self._build([r for r, _, _ in batch])
            except Exception as e:
                for _, fut, _ in batch:
                    _resolve(fut, exc=e)
                continue
            self._ready.put((arrays, focus, batch))

    def _apply_pending_weights(self) -> None:
        with self._weights_lock:
            state_dict, self._pending_weights = self._pending_weights, None
            if state_dict is not None:
                # bumps weights_version, which drops the sampler's uncond
                # cache
                self.model.load_state_dict(state_dict)

    def _run_device(self) -> None:
        """Stage 2: the only thread that sends work to the card.  It
        returns once the batch's work and the copy of its motion to the
        host are queued (the WEG refinement test and loop read the loss on
        the host on the way); the fetch stage waits for them."""
        while True:
            item = self._ready.get()
            if item is None:
                self._done.put(None)
                return
            arrays, focus, batch = item
            try:
                self._apply_pending_weights()
                t0 = time.perf_counter()
                before = dataclasses.astuple(self.model.weg_counts)
                motion, _ = self._sampler(
                    to_tensors(arrays, self.model.device), self._generator,
                    focus=focus)
                host, done = _copy_to_host(motion[:len(batch)])
                weg = [a - b for a, b in zip(
                    dataclasses.astuple(self.model.weg_counts), before)]
                self._done.put((host, done, t0, weg, batch))
            except Exception as e:  # resolve, don't kill the worker
                for _, fut, _ in batch:
                    _resolve(fut, exc=e)

    def _run_fetch(self) -> None:
        """Stage 3: wait for a batch's motion on the host, resolve the
        futures, account."""
        while True:
            item = self._done.get()
            if item is None:
                return
            host, done, t0, weg, batch = item
            try:
                if done is not None:
                    done.synchronize()
                motions = host.float().numpy()
                now = time.perf_counter()
                for i, (_, fut, _) in enumerate(batch):
                    _resolve(fut, motions[i])
                with self._stats_lock:
                    n = len(batch)
                    self._n_requests += n
                    self._n_batches += 1
                    self._rows_used += n
                    self._latencies.extend(now - t for _, _, t in batch)
                    del self._latencies[:-4096]
                    self._batch_ms.append((now - t0) * 1e3)
                    del self._batch_ms[:-4096]
                    self._weg[0] += weg[0]
                    self._weg[1] += weg[1]
            except Exception as e:
                for _, fut, _ in batch:
                    _resolve(fut, exc=e)

    def _build(self, reqs: List[GestureRequest]):
        """Requests -> (numpy arrays, focus or None) at the fixed
        geometry: the tail is padded with repeats of the last request."""
        padded = reqs + [reqs[-1]] * (self.batch_size - len(reqs))
        silence = np.full(self.mel_shape, -80.0, np.float32)
        idle = np.full((self.n_chunks,), 2, np.int32)  # 'none' vocab bit
        mel = np.stack([r.melspec if r.melspec is not None else silence
                        for r in padded])
        apb = np.stack([np.asarray(r.active_passive, np.int32)
                        if r.active_passive is not None else idle
                        for r in padded])
        lsn_id = np.asarray([r.lsn_id for r in padded], np.int32)
        texts_lsn = [r.text_lsn for r in padded]
        texts_spk = [r.text_spk or r.text_lsn for r in padded]
        text, _, tb_lsn = self.model.prepare_text_batch(texts_spk, texts_lsn)
        arrays = {"melspec_lsn": mel, "active_passive_lsn": apb,
                  "lsn_id": lsn_id, **text}
        focus = None
        if self.weg:
            wrapped = self.model.tokenizer.wrapped_texts(texts_lsn)
            fi, fv = focus_word_indices(
                tb_lsn.word_map(wrapped),
                [list(r.focus_words) for r in padded],
                max_indices=self.weg_max_focus)
            focus = {"focus_idx": fi, "focus_valid": fv}
        return arrays, focus


def _drain(q: "queue.Queue"):
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return
        if item is not None:
            yield item


def _copy_to_host(motion: torch.Tensor):
    """(host tensor, CUDA event or None).  On the card the copy goes into
    pinned memory on the current stream, right behind the batch's work,
    and the event marks its end."""
    if not motion.is_cuda:
        return motion, None
    host = torch.empty(motion.shape, dtype=motion.dtype, pin_memory=True)
    host.copy_(motion, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


# ------------------------------------------------------------------- HTTP
class _Handler(BaseHTTPRequestHandler):
    """The JSON endpoints of :func:`serve_http`.  The service is the
    server's attribute, not a closure variable: a class made per call sits
    in a reference cycle of its own, and through the closure it would hold
    the service and its model's weights until the garbage collector ran."""

    def _send(self, code: int, obj: Dict, headers=()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/stats":
            self._send(200, self.server.service.stats())
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            obj = json.loads(self.rfile.read(length) or b"{}")
            req = GestureRequest.from_json(obj)
            t0 = time.perf_counter()
            motion = self.server.service.generate(req)
            self._send(200, {
                "motion": np.asarray(motion, np.float64).tolist(),
                "latency_ms": (time.perf_counter() - t0) * 1e3,
            })
        except ServiceOverloaded as e:
            # advise one batch window before retrying
            self._send(503, {"error": str(e)}, [("Retry-After", "1")])
        except ValueError as e:
            self._send(400, {"error": str(e)})
        except Exception as e:
            self._send(500, {"error": repr(e)})

    def log_message(self, *a):  # quiet by default
        pass


def serve_http(service: GestureService, host: str = "127.0.0.1",
               port: int = 8476) -> ThreadingHTTPServer:
    """Wrap a service in a stdlib JSON HTTP server (returns the server;
    call ``.serve_forever()`` or run it from a thread; ``.shutdown()`` to
    stop).  ``POST /generate`` with a :meth:`GestureRequest.from_json`
    body returns ``{"motion": [[...]], "latency_ms": t}``; an overloaded
    service answers 503 with ``Retry-After``."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    return server


# ------------------------------------------------------------------- CLI
def build_service(cfg, dtype="float32", device=None,
                  checkpoint: Optional[str] = None) -> GestureService:
    """A :class:`GestureService` from a merged YAML config (``config.
    load_config``, mapped by ``config.from_cfg``) or a port config dict
    (``config.PRODUCTION`` or ``config.TINY``, possibly changed): the
    ``serve`` block's knobs, the scheduler's ``num_inference_timesteps`` as
    the step count, and WEG when ``weg_type`` is not ``'no'``
    (convofusion_tpu/serving.py:480-532).  The weights are drawn from the
    ``serve`` seed, which also seeds the service's generator; the T5 trunk
    then comes from the asset drop where there is one, and everything from
    ``checkpoint`` (a port or reference ``.ckpt``; a merged config's
    ``TEST.CHECKPOINTS`` when not given, :500-519).  ``device`` None means
    the card, and raises without one."""
    if not isinstance(cfg, dict):
        checkpoint = checkpoint or str(cfg.TEST.get("CHECKPOINTS", "") or "")
        cfg = from_cfg(cfg, stage="diffusion")
    if checkpoint and not os.path.isfile(checkpoint):
        raise FileNotFoundError(f"checkpoint {checkpoint!r} not found")
    serve = cfg["serve"]
    seed = int(serve["seed"])
    model = Convofusion(cfg, dtype=dtype, device=device, seed=seed)
    maybe_load_t5_assets(model)
    if checkpoint:
        load_torch_full_model(checkpoint, model)
    return GestureService(
        model, batch_size=int(serve["batch_size"]),
        max_wait_ms=float(serve["max_wait_ms"]),
        num_inference_steps=int(cfg["scheduler"]["num_inference_timesteps"]),
        weg=cfg.get("weg_type", "no") != "no",
        weg_max_focus=int(serve["weg_max_focus"]), seed=seed,
        max_queue=serve["max_queue"])


def _config(args):
    """The port config dict of the CLI's arguments, and the checkpoint."""
    checkpoint = args.checkpoint
    if args.cfg:
        merged = load_config(args.cfg, args.cfg_assets,
                             overrides=args.overrides, phase="test")
        checkpoint = checkpoint or str(
            merged.TEST.get("CHECKPOINTS", "") or "")
        cfg = from_cfg(merged, stage="diffusion")
    else:
        cfg = copy.deepcopy(PRODUCTION if args.geometry != "tiny" else TINY)
    serve = cfg["serve"]
    for key in ("batch_size", "max_wait_ms", "host", "port"):
        if getattr(args, key) is not None:
            serve[key] = getattr(args, key)
    if args.max_queue is not None:
        # negative: the default bound, 8 x batch_size
        serve["max_queue"] = args.max_queue if args.max_queue >= 0 else None
    if args.steps is not None:
        cfg["scheduler"]["num_inference_timesteps"] = args.steps
    if args.weg is not None:
        cfg["weg_type"] = "semantic" if args.weg == "on" else "no"
    return cfg, checkpoint


def main(argv=None):
    """``python -m convofusion_tpu_torch.serving [--cfg <yaml> [key=value
    ...] | --geometry tiny] [--device cpu --checkpoint <ckpt> ...]``: the
    micro-batching service behind the JSON HTTP endpoint (``POST
    /generate``, ``GET /stats``, ``GET /healthz``), until interrupted.  The
    flags override the config's ``SERVE`` block and step count."""
    p = argparse.ArgumentParser(
        prog="python -m convofusion_tpu_torch.serving",
        description="Serve gesture generation over HTTP.")
    p.add_argument("--cfg", help="experiment YAML, merged as "
                                 "convofusion_tpu.serving --cfg merges it")
    p.add_argument("--cfg_assets", help="assets YAML (with --cfg)")
    p.add_argument("overrides", nargs="*",
                   help="dotlist overrides key=value (with --cfg)")
    p.add_argument("--geometry", choices=("production", "tiny"),
                   help="a built-in config instead of --cfg (default "
                        "production)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--device", default=None,
                   help="torch device; default the card ('cpu' for the "
                        "plain PyTorch path)")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--max-wait-ms", type=float)
    p.add_argument("--max-queue", type=int,
                   help="intake bound; 0 unbounded, negative 8 x batch")
    p.add_argument("--steps", type=int, help="reverse diffusion steps")
    p.add_argument("--weg", choices=("on", "off"),
                   help="word-excitation guidance (default: the config's)")
    p.add_argument("--host")
    p.add_argument("--port", type=int, help="0 picks a free port")
    p.add_argument("--checkpoint",
                   help="a port or reference .ckpt (default: the config's "
                        "TEST.CHECKPOINTS; else random weights)")
    args = p.parse_intermixed_args(argv)
    if args.cfg and args.geometry:
        p.error("--cfg and --geometry exclude each other")
    if not args.cfg and (args.overrides or args.cfg_assets):
        p.error("overrides and --cfg_assets need --cfg")
    cfg, checkpoint = _config(args)
    service = build_service(cfg, args.dtype, args.device, checkpoint)
    server = serve_http(service, host=str(cfg["serve"]["host"]),
                        port=int(cfg["serve"]["port"]))
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} ("
          f"{args.cfg or args.geometry or 'production'}, "
          f"{checkpoint or 'random weights'}, {args.dtype} on "
          f"{service.model.device}, batch={service.batch_size}, "
          f"wait={service.max_wait * 1e3:.0f}ms, weg={service.weg})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
