#!/usr/bin/env python3
"""Drive the PyTorch port of ConvoFusion on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising on failure (non-zero exit, no result line):
  1. device  - require CUDA; print the card's name and power limit; TF32 off
  2. build   - nvcc the hand-written kernels from convofusion_tpu_torch/csrc
  3. kernel  - at the main path's B=96 shapes, every kernel against its
               plain PyTorch version on the card (DDPM mid, DDPM final,
               DDIM; fp32 and bf16 branch planes), max |diff| <= 1e-5;
               CUDA-event times of kernel (L2 flushed, and back to back)
               and plain version; then the step kernel's tile and block
               size sweep at the main path's case (bf16 planes, DDIM)
  4. parity  - production geometry, fp32, batch 2, DDIM-50, seeded weights,
               numpy-made inputs and noise: sample() on the card (through
               the kernel) against sample() on the CPU (plain version)
  5. main    - production geometry, bf16, batch 96, DDIM-50, 7-way
               guidance through Convofusion.sample: one warm-up and three
               timed calls; (96, 128, 189) finite motion and exactly 50
               kernel launches per call; clips/s, ms/call, peak memory,
               one call split into encode / reverse / decode, and a
               profile of a few reverse steps, which gives the step
               kernel's device time inside the loop (in_path_us)
  6. weg_parity - production geometry, fp32, batch 2, DDIM-10, word-
               excitation guidance (WEG) with focus words on both rows,
               numpy-made inputs and noise: sample(focus=...) on the card
               against the CPU, with the config's WEG parameters and with
               the refinement forced at step 0; refinement iterations and
               text-only passes must be equal on both sides
  7. serve   - production geometry, bf16, batch 96, DDIM-50, WEG on,
               through build_service and GestureService: 2 x 96 requests
               from client threads (most with 1-3 focus words of their own
               text), a few more through serve_http on a loopback port;
               (128, 189) finite motion for every request, exactly 50
               kernel launches per micro-batch; batch ms, requests/s,
               latency p50/p95, occupancy, peak memory, WEG counts per
               batch; then direct sample() calls on one assembled batch
               with and without focus, for WEG's own cost and the
               pipeline's
Then a JSON line of per-kernel numbers (launches summed over phases 5-7,
and each phase's count under launches_by_phase)
and, last, the result line {"ok": true, "device": {...}}.
"""
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from convofusion_tpu_torch.config import PRODUCTION
from convofusion_tpu_torch.diffusion.schedulers import DiffusionScheduler
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion, to_tensors
from convofusion_tpu_torch.models.tokenizer import focus_word_indices
from convofusion_tpu_torch.ops import guided_step as gs_mod
from convofusion_tpu_torch.serving import (
    GestureRequest,
    build_service,
    serve_http,
)

BATCH, STEPS, TIMED_CALLS = 96, 50, 3   # bench.py:26-29 (batch, steps)
KERNEL_TOL = 1e-5
TIMING_RUNS = 200
PROFILE_STEPS = 5
# the step kernel's (elements a block, threads a block) at the main path's
# case: 192, 128 and 96 blocks at B = 96 on the card's 132 SMs
SWEEP = [(tile, threads) for tile in (1024, 1536, 2048)
         for threads in (128, 256)]
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# fp32 (non-tensor-core) flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# guided_step per element: 8 for the guidance combine, 5 for x0 and its
# clip, 6-7 for the DDPM or DDIM update
STEP_FLOPS_PER_ELEMENT = 20
# card-vs-CPU fp32 motion after 50 guided steps: see phase_parity
PARITY_ATOL = 1e-3
# phase 6: DDIM-10 with WEG; the tolerance is argued in phase_weg_parity
WEG_STEPS = 10
WEG_PARITY_ATOL = 1e-3
WEG_LATENT_ATOL = 2e-3
# the refinement forced at step 0: the loop runs to its bound on both sides
WEG_FORCED = {"thresholds": {0: 0.99}, "max_refinement_steps": 5}
# phase 7: requests a client thread submits, and the HTTP requests
SERVE_CLIENTS, SERVE_HTTP_REQUESTS = 8, 4
# every Nth service request carries no focus words
NO_FOCUS_EVERY = 5


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    log(f"# card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    t0 = time.perf_counter()
    report = gs_mod.build()
    log(f"# build: guided_step.cu in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   {line.strip()}")


def _event_median_ms(fn, flush):
    """Median over TIMING_RUNS of one call bracketed by CUDA events, with
    the 50 MB L2 overwritten before each call: the inputs come from DRAM,
    and the flush keeps the card busy while the host enqueues the call, so
    host latency stays out of the bracket."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMING_RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMING_RUNS)]
    for _ in range(5):
        fn()
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _back_to_back_ms(fn):
    """Mean of TIMING_RUNS launches queued back to back behind a device
    sleep, so the card runs them without waiting for the host: inputs stay
    in L2, as when the denoiser has just written noise_pred."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # ~50 ms of cycles to enqueue behind
    start.record()
    for _ in range(TIMING_RUNS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMING_RUNS


def step_bound_ms(np7, latents, reads_noise):
    """Least time for one step: bytes of the inputs the output depends on
    (branches 0-5, latents, the noise where it enters) and the output,
    against the flops, at the H100 peaks."""
    plane = latents.numel()
    nbytes = (6 * plane * np7.element_size()
              + latents.numel() * 4 * (3 if reads_noise else 2))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = plane * STEP_FLOPS_PER_ELEMENT / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


@contextlib.contextmanager
def step_geometry(tile, threads):
    """guided_step launches with bf16 branch planes at this tile and block
    size while the context is open."""
    saved = gs_mod.TILE, gs_mod.THREADS
    gs_mod.TILE, gs_mod.THREADS = {**saved[0], 2: tile}, threads
    try:
        yield
    finally:
        gs_mod.TILE, gs_mod.THREADS = saved


def kernel_error(args) -> float:
    """max |kernel - plain version| on the card; raises above KERNEL_TOL."""
    got = gs_mod.guided_step(*args)
    torch.cuda.synchronize()
    want = gs_mod.guided_step_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= KERNEL_TOL:
        raise RuntimeError(f"guided_step {args[0].dtype} {args[3:]}: max "
                           f"|diff| {err} > {KERNEL_TOL}")
    return err


def step_inputs(dtype=torch.bfloat16, batch=BATCH):
    """Seeded (7, B, 16, 128) branch planes, latents and noise on the card,
    and the three step cases (alpha_t, alpha_prev, is_ddpm, add_noise)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (batch, 16, PRODUCTION["latent_dim"][1])
    np7 = torch.randn((7,) + shape, generator=gen, device="cuda").to(dtype)
    lat = torch.randn(shape, generator=gen, device="cuda")
    noise = torch.randn(shape, generator=gen, device="cuda")
    table = DiffusionScheduler().alphas_cumprod
    cases = {
        "ddpm_mid": (table[500], table[480], 1.0, 1.0),
        "ddpm_final": (table[0], 1.0, 1.0, 0.0),
        "ddim": (table[980], table[960], 0.0, 1.0),
    }
    return np7, lat, noise, {
        name: (float(a_t), float(a_prev), PRODUCTION["guidance_scale"],
               is_ddpm, add_noise, 1.0)
        for name, (a_t, a_prev, is_ddpm, add_noise) in cases.items()}


def phase_kernel():
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    rows, max_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        np7, lat, noise, cases = step_inputs(dtype)
        for name, scalars in cases.items():
            args = (np7, lat, noise) + scalars
            err = kernel_error(args)
            max_err = max(max_err, err)
            ms = _event_median_ms(lambda: gs_mod.guided_step(*args), flush)
            warm_ms = _back_to_back_ms(lambda: gs_mod.guided_step(*args))
            plain_ms = _event_median_ms(
                lambda: gs_mod.guided_step_reference(*args), flush)
            bound, bound_by = step_bound_ms(
                np7, lat, scalars[3] > 0 and scalars[4] > 0)
            key = f"{name}/{str(dtype).split('.')[-1]}"
            rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by)
            log(f"# kernel guided_step {key}: max|diff| {err:.3g}  kernel "
                f"{ms * 1e3:.2f} us (back to back, L2 warm {warm_ms * 1e3:.2f} "
                f"us)  plain "
                f"{plain_ms * 1e3:.2f} us  bound {bound * 1e3:.2f} us "
                f"({bound_by})")

    # the sweep, at the main path's case: bf16 planes, DDIM
    args = (np7, lat, noise) + cases["ddim"]
    for tile, threads in SWEEP:
        with step_geometry(tile, threads):
            err = kernel_error(args)
            ms = _event_median_ms(lambda: gs_mod.guided_step(*args), flush)
            warm_ms = _back_to_back_ms(lambda: gs_mod.guided_step(*args))
        log(f"# sweep guided_step ddim/bfloat16 tile {tile} threads "
            f"{threads} ({-(-lat.numel() // tile)} blocks): max|diff| "
            f"{err:.3g}  kernel {ms * 1e3:.2f} us  back to back "
            f"{warm_ms * 1e3:.2f} us")
    return rows, max_err


def _noise(rng, n_steps, shape):
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    steps = torch.from_numpy(
        rng.standard_normal((n_steps,) + shape).astype(np.float32))
    return init, steps


def phase_parity():
    """Same seeded weights, inputs and noise on the card and on the CPU, in
    fp32 with TF32 off.  GEMM summation order differs between cuBLAS and
    the CPU BLAS; the guidance combine scales each branch's rounding by
    gs * 5 = 37.5 and 50 steps with x0 clipping compound it.  On an H100
    the motion (|motion| <= 3.2) differed by 4.8e-5: PARITY_ATOL leaves
    20x headroom."""
    b = 2
    raw = synthetic_raw_batch(11, b, mel_frames=PRODUCTION["mel_frames"])
    init, steps = _noise(np.random.default_rng(12), STEPS,
                         (b, 16, PRODUCTION["latent_dim"][1]))
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = Convofusion(PRODUCTION, dtype="float32", device=device,
                            seed=0)
        batch, _, _ = prepare_arrays(model, raw)
        launches = gs_mod.guided_step.launches
        motion, latents = model.sample(batch, num_inference_steps=STEPS,
                                       init_noise=init, step_noise=steps)
        if device == "cuda" and gs_mod.guided_step.launches - launches \
                != STEPS:
            raise RuntimeError("parity run on the card missed the kernel")
        out[device] = (motion.float().cpu(), latents.cpu())
        del model
        log(f"# parity: sample() on {device} in "
            f"{time.perf_counter() - t0:.1f} s")
    (m_gpu, l_gpu), (m_cpu, l_cpu) = out["cuda"], out["cpu"]
    for t in (m_gpu, m_cpu):
        if t.shape != (b, 128, 189) or not torch.isfinite(t).all():
            raise RuntimeError(f"parity motion {tuple(t.shape)} not finite "
                               f"or misshapen")
    dm = float((m_gpu - m_cpu).abs().max())
    dl = float((l_gpu - l_cpu).abs().max())
    log(f"# parity: fp32 DDIM-{STEPS} batch {b} card vs CPU: max|motion "
        f"diff| {dm:.3g} (|motion| <= {float(m_cpu.abs().max()):.3g}), "
        f"max|latent diff| {dl:.3g}; tolerance {PARITY_ATOL}")
    if not dm <= PARITY_ATOL:
        raise RuntimeError(f"card vs CPU motion differ by {dm}")
    return dm


def focus_words(texts, rng):
    """1-3 distinct words of each text as its focus words; every
    NO_FOCUS_EVERY-th text none."""
    out = []
    for i, text in enumerate(texts):
        words = sorted(set(text.split()))
        if i % NO_FOCUS_EVERY == NO_FOCUS_EVERY - 1:
            out.append(())
            continue
        k = min(int(rng.integers(1, 4)), len(words))
        out.append(tuple(str(w) for w in rng.choice(words, size=k,
                                                     replace=False)))
    return out


def phase_weg_parity(device="cuda"):
    """sample(focus=...) on the card and on the CPU from the same seeded
    weights, inputs and noise, fp32, TF32 off.  Besides the GEMM order
    (phase 4), each WEG step moves the latents by ~1000 x the gradient of
    the focus loss, and the focus-column gather's backward adds with
    atomics on the card, so the card's gradient is not bit-reproducible;
    the refinement counts must still agree.  On an H100 the motion (|motion|
    <= 4.2) differed by 2.7e-5 with the config's parameters and 3.1e-5
    with the refinement forced: WEG_PARITY_ATOL leaves 30x headroom.  The
    latents, where WEG's gradient steps land, differed by 2.0e-4 and
    2.1e-4: WEG_LATENT_ATOL leaves ~10x headroom.  Returns the larger max
    |motion diff| of the two runs."""
    b = 2
    raw = synthetic_raw_batch(31, b, mel_frames=PRODUCTION["mel_frames"])
    init, steps = _noise(np.random.default_rng(32), WEG_STEPS,
                         (b, 16, PRODUCTION["latent_dim"][1]))
    words = focus_words(raw["text_lsn"], np.random.default_rng(33))
    words = [w or tuple(t.split()[:1]) for w, t in zip(words,
                                                       raw["text_lsn"])]
    runs = {}
    for side in (device, "cpu"):
        model = Convofusion(PRODUCTION, dtype="float32", device=side,
                            seed=0)
        batch, _, tb_lsn = prepare_arrays(model, raw)
        fi, fv = focus_word_indices(
            tb_lsn.word_map(model.tokenizer.wrapped_texts(raw["text_lsn"])),
            [list(w) for w in words], max_indices=8)
        for name, params in (("config", None), ("forced", WEG_FORCED)):
            t0 = time.perf_counter()
            model.weg_counts = type(model.weg_counts)()
            launches = gs_mod.guided_step.launches
            motion, latents = model.sample(
                batch, num_inference_steps=WEG_STEPS, init_noise=init,
                step_noise=steps, focus={"focus_idx": fi,
                                         "focus_valid": fv},
                weg_params=params)
            if side != "cpu" and gs_mod.guided_step.launches - launches \
                    != WEG_STEPS:
                raise RuntimeError("WEG parity run on the card missed the "
                                   "kernel")
            runs[side, name] = (motion.float().cpu(), latents.cpu(),
                                model.weg_counts)
            log(f"# weg_parity: {name} parameters on {side}: "
                f"{time.perf_counter() - t0:.1f} s, {model.weg_counts}")
        del model
    log(f"# weg_parity: focus words {words}, valid columns "
        f"{fv.sum(axis=1).tolist()}")
    worst = 0.0
    for name in ("config", "forced"):
        (m_gpu, l_gpu, c_gpu), (m_cpu, l_cpu, c_cpu) = (
            runs[device, name], runs["cpu", name])
        for t in (m_gpu, m_cpu):
            if t.shape != (b, 128, 189) or not torch.isfinite(t).all():
                raise RuntimeError(f"WEG parity motion {tuple(t.shape)} not "
                                   f"finite or misshapen")
        if c_gpu != c_cpu:
            raise RuntimeError(f"WEG counts differ: card {c_gpu}, CPU "
                               f"{c_cpu}")
        dm = float((m_gpu - m_cpu).abs().max())
        dl = float((l_gpu - l_cpu).abs().max())
        log(f"# weg_parity: {name}: fp32 DDIM-{WEG_STEPS} batch {b} card vs "
            f"CPU: refinement iterations at step 0 {c_gpu.refinement_iterations}"
            f" / {c_cpu.refinement_iterations}, text-only passes "
            f"{c_gpu.text_only_passes} / {c_cpu.text_only_passes}; max|motion "
            f"diff| {dm:.3g} (|motion| <= {float(m_cpu.abs().max()):.3g}), "
            f"max|latent diff| {dl:.3g}; tolerances {WEG_PARITY_ATOL} "
            f"(motion), {WEG_LATENT_ATOL} (latents)")
        if not dm <= WEG_PARITY_ATOL:
            raise RuntimeError(f"WEG card vs CPU motion differ by {dm}")
        if not dl <= WEG_LATENT_ATOL:
            raise RuntimeError(f"WEG card vs CPU latents differ by {dl}")
        worst = max(worst, dm)
    return worst


def _serve_requests(n, seed):
    raw = synthetic_raw_batch(seed, n, mel_frames=PRODUCTION["mel_frames"])
    words = focus_words(raw["text_lsn"], np.random.default_rng(seed + 1))
    return [GestureRequest(
        text_lsn=raw["text_lsn"][i], text_spk=raw["text_spk"][i],
        melspec=raw["melspec_lsn"][i],
        active_passive=raw["active_passive_lsn"][i],
        lsn_id=int(raw["lsn_id"][i]), focus_words=words[i])
        for i in range(n)]


def _submit_from_clients(svc, reqs, clients):
    """Each client thread submits its share, then waits on its futures.
    Returns the motions in request order and the wall time."""
    out = [None] * len(reqs)
    errors = []

    def client(c):
        try:
            futs = [(i, svc.submit(reqs[i]))
                    for i in range(c, len(reqs), clients)]
            for i, fut in futs:
                out[i] = fut.result(timeout=600)
        except Exception as e:  # re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"service clients failed: {errors[:1]}")
    return out, wall


def _check_served(motions, what):
    for m in motions:
        if m is None or m.shape != (128, 189) or not np.isfinite(m).all():
            raise RuntimeError(f"{what}: a request resolved to "
                               f"{None if m is None else m.shape} or to "
                               f"non-finite motion")


def _post(url, req):
    body = json.dumps({
        "text_lsn": req.text_lsn, "text_spk": req.text_spk,
        "melspec": req.melspec.tolist(),
        "active_passive": req.active_passive.tolist(),
        "lsn_id": req.lsn_id, "focus_words": list(req.focus_words)}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"{url}/generate", data=body,
            headers={"Content-Type": "application/json"}),
            timeout=600) as resp:
        return np.asarray(json.loads(resp.read())["motion"], np.float32)


def phase_serve(smi, device=None):
    """The production service with WEG at batch 96 through its own entry
    points.  Returns the step-kernel launches after the warm-up batch:
    the service's batches and the 4 direct calls."""
    cfg = copy.deepcopy(PRODUCTION)
    cfg["serve"].update(batch_size=BATCH, max_wait_ms=1000.0)
    cfg["scheduler"]["num_inference_timesteps"] = STEPS
    cfg["weg_type"] = "semantic"
    svc = build_service(cfg, dtype="bfloat16", device=device)
    on_card = svc.model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        # warm-up: one full batch, then the counters start at 0
        warm, _ = _submit_from_clients(svc, _serve_requests(BATCH, 40),
                                       SERVE_CLIENTS)
        _check_served(warm, "serve warm-up")
        svc.reset_stats()
        gs_mod.guided_step.launches = 0
        reqs = _serve_requests(2 * BATCH, 41)
        motions, wall = _submit_from_clients(svc, reqs, SERVE_CLIENTS)
        _check_served(motions, "serve")
        st = svc.stats()
        launches = gs_mod.guided_step.launches
        if st["requests"] != 2 * BATCH or \
                (on_card and launches != STEPS * st["batches"]):
            raise RuntimeError(f"serve: {st['requests']} requests in "
                               f"{st['batches']} batches with {launches} "
                               f"kernel launches, want {STEPS} a batch")
        n_focus = sum(bool(r.focus_words) for r in reqs)
        log(f"# serve: bf16 batch {BATCH} DDIM-{STEPS} WEG on {smi}: "
            f"{st['requests']} requests ({n_focus} with focus words) from "
            f"{SERVE_CLIENTS} client threads in {st['batches']} batches, "
            f"{wall * 1e3:.1f} ms wall, {st['requests'] / wall:.2f} "
            f"requests/s; batch {st['batch_ms_p50']:.1f} ms (p50), latency "
            f"p50 {st['latency_p50_ms']:.1f} ms p95 "
            f"{st['latency_p95_ms']:.1f} ms, occupancy "
            f"{st['occupancy']:.3f}; a batch: "
            f"{st['text_only_passes'] / st['batches']:.1f} text-only "
            f"passes, {st['refinement_iterations'] / st['batches']:.1f} "
            f"refinement iterations, {launches / st['batches']:.1f} kernel "
            f"launches")

        # a few requests over HTTP on a loopback port
        server = serve_http(svc, port=0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            host, port = server.server_address[:2]
            url = f"http://{host}:{port}"
            http_reqs = _serve_requests(SERVE_HTTP_REQUESTS, 42)
            got = [None] * len(http_reqs)

            def post(i):
                got[i] = _post(url, http_reqs[i])

            t0 = time.perf_counter()
            posters = [threading.Thread(target=post, args=(i,))
                       for i in range(len(http_reqs))]
            for p in posters:
                p.start()
            for p in posters:
                p.join(timeout=600)
            http_ms = (time.perf_counter() - t0) * 1e3
            _check_served(got, "serve over HTTP")
            with urllib.request.urlopen(f"{url}/stats", timeout=60) as resp:
                http_st = json.loads(resp.read())
            if http_st["requests"] != 2 * BATCH + SERVE_HTTP_REQUESTS:
                raise RuntimeError(f"GET /stats counts {http_st['requests']}"
                                   f" requests")
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=60)
        log(f"# serve: {SERVE_HTTP_REQUESTS} requests over HTTP in "
            f"{http_ms:.1f} ms; GET /stats: {http_st['requests']} requests, "
            f"{http_st['batches']} batches, occupancy "
            f"{http_st['occupancy']:.3f}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0

        # one assembled batch straight through sample(), with and without
        # focus: WEG's own cost, and the pipeline's against the batch time
        arrays, focus = svc._build(reqs[:BATCH])
        model, gen = svc.model, torch.Generator(device=svc.model.device)
        gen.manual_seed(43)
        sampler = model.cached_sampler(num_inference_steps=STEPS)
        direct = {}
        for name, f in (("with focus", focus), ("without focus", None),
                        ("with focus", focus), ("without focus", None)):
            t0 = time.perf_counter()
            motion, _ = sampler(to_tensors(arrays, model.device), gen,
                                focus=f)
            if on_card:
                torch.cuda.synchronize()
            direct.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            _check_served(list(motion.float().cpu().numpy()), "direct")
        launches = gs_mod.guided_step.launches
        if on_card and launches != STEPS * (http_st["batches"] + 4):
            raise RuntimeError(f"serve: {launches} kernel launches over "
                               f"{http_st['batches']} service batches and 4 "
                               f"direct calls")
        log(f"# serve: direct sample() of one assembled batch: with focus "
            f"{direct['with focus']} ms, without {direct['without focus']} "
            f"ms; the service's batch {st['batch_ms_p50']:.1f} ms (p50); "
            f"peak memory {peak / 2**30:.2f} GiB")
        if on_card:
            profile_weg(model, to_tensors(arrays, model.device), focus, gen,
                        sampler.uncond_for(to_tensors(arrays,
                                                      model.device)))
    finally:
        svc.close()
    return launches


def profile_weg(model, batch, focus, gen, uncond):
    """PROFILE_STEPS-step sample() calls on one batch with and without
    focus under the profiler: the difference is what WEG adds to a step
    (kernels and device time); busy over wall is the card's share."""
    rows = {}
    for name, f in (("with focus", focus), ("without focus", None)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.sample(batch, gen, PROFILE_STEPS, uncond_cache=uncond,
                         focus=f)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        count = sum(e.count for e in kernels)
        rows[name] = (wall_ms, busy_ms, count)
        log(f"# profile: sample() of {PROFILE_STEPS} steps {name}: wall "
            f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({busy_ms / wall_ms:.1%}), {count} kernels")
    (w1, b1, c1), (w0, b0, c0) = rows["with focus"], rows["without focus"]
    log(f"# profile: WEG adds a step {(c1 - c0) / PROFILE_STEPS:.0f} "
        f"kernels, {(b1 - b0) / PROFILE_STEPS:.1f} ms of device time and "
        f"{(w1 - w0) / PROFILE_STEPS:.1f} ms of wall (under the profiler)")


def phase_main(smi):
    model = Convofusion(PRODUCTION, dtype="bfloat16", seed=1)
    raw = synthetic_raw_batch(21, BATCH, mel_frames=PRODUCTION["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    gen = torch.Generator(device=model.device).manual_seed(22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    gs_mod.guided_step.launches = 0
    times = []
    for call in range(1 + TIMED_CALLS):
        before = gs_mod.guided_step.launches
        t0 = time.perf_counter()
        motion, latents = model.sample(batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if gs_mod.guided_step.launches - before != STEPS:
            raise RuntimeError(
                f"call {call}: {gs_mod.guided_step.launches - before} "
                f"kernel launches, want {STEPS}")
        if tuple(motion.shape) != (BATCH, 128, 189) or \
                not torch.isfinite(motion).all() or \
                not torch.isfinite(latents).all():
            raise RuntimeError(f"main path motion {tuple(motion.shape)} "
                               f"misshapen or not finite")
        if call:
            times.append(dt)
        log(f"# main: call {call} {'(warm-up) ' if not call else ''}"
            f"{dt * 1e3:.1f} ms")
    launches = gs_mod.guided_step.launches
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"# main: bf16 batch {BATCH} DDIM-{STEPS} 7-way guidance on {smi}: "
        f"{BATCH / med:.2f} clips/s, {med * 1e3:.1f} ms/call (median of "
        f"{TIMED_CALLS}), peak memory {peak / 2**30:.2f} GiB, "
        f"{launches} kernel launches over {1 + TIMED_CALLS} calls, "
        f"|motion| <= {float(motion.float().abs().max()):.3g}")

    # one more call split by layer, synchronising between the parts
    with torch.inference_mode():
        t0 = time.perf_counter()
        keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask",
                "melspec_lsn", "active_passive_lsn", "lsn_id")
        cond, masks = model.encode_conditions(*(batch[k] for k in keys))
        unc, umasks = model.encode_uncond(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lat = model.diffusion_reverse(cond, masks, unc, umasks, BATCH,
                                      generator=gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        z = lat.reshape(BATCH, 8, 2, -1)
        model.vae.decode(torch.stack([z[:, :, 0], z[:, :, 1]]), 128)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    log(f"# main: split encode {(t1 - t0) * 1e3:.1f} ms, reverse "
        f"{(t2 - t1) * 1e3:.1f} ms ({(t2 - t1) / STEPS * 1e3:.2f} ms/step), "
        f"decode {(t3 - t2) * 1e3:.1f} ms")

    # where a reverse step's time goes: PROFILE_STEPS steps under the
    # profiler (which adds host overhead of its own)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.diffusion_reverse(cond, masks, unc, umasks, BATCH,
                                num_inference_steps=PROFILE_STEPS,
                                generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    log(f"# profile: {PROFILE_STEPS} reverse steps: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(e.count for e in kernels) // PROFILE_STEPS} kernels a step")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        log(f"#   {_device_us(e) / 1e3:8.3f} ms {e.count:6d}x  {e.key[:100]}")
    in_path_us = kernel_in_path_us(kernels, PROFILE_STEPS)
    log(f"# profile: guided_step in the loop: {in_path_us:.2f} us a launch "
        f"(device time over the {PROFILE_STEPS} launches)")
    return launches, in_path_us


def _device_us(event):
    """Device time of a kernel row of the profiler."""
    return event.self_device_time_total


def kernel_in_path_us(kernels, expected) -> float:
    """The step kernel's device time a launch, from the profiler's kernel
    rows of a reverse loop that launched it ``expected`` times."""
    rows = [e for e in kernels if "guided_step_kernel" in e.key]
    count = sum(e.count for e in rows)
    if count != expected:
        raise RuntimeError(f"profile shows {count} guided_step launches, "
                           f"want {expected}")
    return sum(_device_us(e) for e in rows) / count


def main():
    smi = phase_device()
    phase_build()
    rows, max_err = phase_kernel()
    phase_parity()
    by_phase = {}
    by_phase["main"], in_path_us = phase_main(smi)
    gs_mod.guided_step.launches = 0
    phase_weg_parity()
    by_phase["weg_parity"] = gs_mod.guided_step.launches
    by_phase["serve"] = phase_serve(smi)

    main_row = rows["ddim/bfloat16"]   # the main path's variant and dtype
    kernels = [{
        "name": "guided_step",
        "route": "cuda",
        "source": "convofusion_tpu_torch/csrc/guided_step.cu",
        "replaces": "convofusion_tpu/ops/pallas_step.py:36",
        "launches": sum(by_phase.values()),
        "launches_by_phase": by_phase,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "in_path_us": in_path_us,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
