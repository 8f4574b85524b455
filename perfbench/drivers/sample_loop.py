"""Closed loop of guided sampling calls through ``CachedSampler.__call__``.

Each call takes the next of the traffic's seeded request batches: the
program tokenizes both texts (``prepare_text_batch``), moves the batch
(``to_tensors``), samples from a seeded initial noise and copies the
motion to the host; the next call starts when it has landed.  Set-up
builds the model from seeded weights, runs one DDIM-2 call at the cell's
shapes (a call's one-time costs fall in its first step) and encodes the
50-step sampler's uncond rows.

After the window, with ``trace``: one call split at the program's layer
boundaries with a synchronise at each (spans ``encode``, ``reverse``,
``decode``), then one call under the profiler.  Correctness: the motion
and latents of ``checked_calls`` distinct batches, drawn from the seed
among those the window completed, against the fp32 reference run on the
same texts, mels, ids and noise.
"""
from __future__ import annotations

import gc
import time

import numpy as np


def _program(ctx, weights):
    import torch
    from convofusion_tpu_torch.models.convofusion import Convofusion

    dev = torch.device(ctx.device)
    with torch.device(dev):
        model = Convofusion(ctx.cfg, dtype=ctx.config["compute_dtype"],
                            device=dev, seed=None, stage="diffusion")
    model.load_state_dict(weights)
    return model


def inputs(ctx, dev):
    """What the benchmark makes from the seed: the weights, the pool of
    request batches and each batch's initial noise (B, 16, D)."""
    import torch

    from perfbench import traffic
    from perfbench import weights as W
    from perfbench.reference import model as R

    weights = W.draw(R.param_specs(ctx.cfg, "diffusion"), ctx.seed, dev)
    pool = traffic.batches(ctx.traffic, ctx.seed)
    shape = (int(ctx.traffic["batch"]), 2 * int(ctx.cfg["max_len"]) // 16,
             int(ctx.cfg["latent_dim"][1]))
    gen = torch.Generator(device=dev).manual_seed(W.stream(ctx.seed, 1))
    return weights, pool, [torch.randn(shape, generator=gen, device=dev)
                           for _ in pool]


def checked(ctx, done):
    """The pool indices whose calls a run compares: ``checked_calls``
    of those the window completed, drawn from the seed."""
    rng = np.random.default_rng([ctx.seed, 1])
    return sorted(int(k) for k in rng.choice(
        sorted(done), size=min(int(ctx.traffic["checked_calls"]), len(done)),
        replace=False))


def run(ctx):
    import torch
    from convofusion_tpu_torch.models.convofusion import to_tensors

    from perfbench import checks
    from perfbench import trace
    from perfbench.reference.tokenizer import write_spiece

    p = ctx.traffic
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    spiece = write_spiece(f"{ctx.workdir}/spiece.model")
    ctx.cfg["t5_path"] = spiece
    weights, pool, noises = inputs(ctx, dev)
    model = _program(ctx, weights)
    b = int(p["batch"])
    shape = tuple(noises[0].shape)
    steps = int(ctx.cfg["scheduler"]["num_inference_timesteps"])
    step_noise = torch.zeros((steps,) + shape, device=dev)
    sampler = model.cached_sampler()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    span = trace.span if ctx.trace else trace.no_span

    def arrays_of(k):
        raw = pool[k]
        with span("prepare_text_batch"):
            text, _, _ = model.prepare_text_batch(raw["text_spk"],
                                                  raw["text_lsn"])
        with span("to_tensors"):
            return to_tensors({**text, "melspec_lsn": raw["mel"],
                               "active_passive_lsn": raw["apb"],
                               "lsn_id": raw["lsn_id"]}, dev)

    def call(i, smp=sampler, sn=step_noise):
        k = i % len(pool)
        arrays = arrays_of(k)
        with span("sampler"):
            motion, latents = smp(arrays, init_noise=noises[k],
                                  step_noise=sn)
        with span("motion_to_host"):
            return k, motion.cpu(), latents

    with torch.no_grad():
        call(0, model.cached_sampler(2), step_noise[:2])
        sampler.uncond_for(arrays_of(0))
    sync()
    setup_s = time.perf_counter() - ctx.t_start

    outputs, calls, ends = {}, 0, []
    t0 = time.perf_counter()
    while True:
        k, motion, latents = call(calls)
        outputs.setdefault(k, (motion, latents))
        calls += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    window_s = ends[-1]

    rec = {"setup_s": setup_s, "window_s": window_s, "attempted": calls,
           "failed": 0, "calls": calls, "clips": calls * b,
           "steps_per_call": steps,
           "unit_s": [y - x for x, y in zip([0.0] + ends, ends)]}
    if ctx.trace:
        rec["spans"] = _split_call(model, sampler, arrays_of(calls % len(
            pool)), noises[calls % len(pool)], step_noise, b, sync)
        rec["trace"] = trace.profiled("pb_window", lambda: call(calls + 1),
                                      ctx.workdir)
        rec["trace_calls"] = 1
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if on_card else 0)

    chosen = checked(ctx, outputs)
    got = {k: outputs[k] for k in chosen}
    del model, sampler, outputs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["readings"] = checks.sample_readings(
        ctx, weights, [pool[k] for k in chosen], [noises[k] for k in chosen],
        [got[k] for k in chosen], spiece)
    rec["check_s"] = time.perf_counter() - t
    return rec


def _split_call(model, sampler, arrays, noise, step_noise, b, sync):
    """One call through the steps ``Convofusion.sample`` takes, timed
    apart: seconds of the condition encoders, the reverse loop and the
    decode."""
    import torch

    spans = {}
    with torch.no_grad():
        sync()
        t = time.perf_counter()
        cond, masks = model.encode_conditions(
            arrays["spk_ids"], arrays["spk_tmask"], arrays["lsn_ids"],
            arrays["lsn_tmask"], arrays["melspec_lsn"],
            arrays["active_passive_lsn"], arrays["lsn_id"])
        sync()
        spans["encode"] = [time.perf_counter() - t]
        cond_u, masks_u = sampler.uncond_for(arrays)
        t = time.perf_counter()
        lat = model.diffusion_reverse(cond, masks, cond_u, masks_u, b,
                                      init_noise=noise,
                                      step_noise=step_noise)
        sync()
        spans["reverse"] = [time.perf_counter() - t]
        t = time.perf_counter()
        z = lat.reshape(b, model.n_chunks, 2, model.latent_dim)
        model.vae.decode(torch.stack([z[:, :, 0], z[:, :, 1]]),
                         model.max_len)
        sync()
        spans["decode"] = [time.perf_counter() - t]
    return spans
