"""Training steps through ``Trainer.compute_grads`` and ``apply_grads``.

Set-up builds one model from seeded weights and one ``Trainer`` (bf16
weights, fp32 masters and moments), makes the traffic's seeded host
batches (tokenized once, as a data pipeline caches them) and the steps'
draws on the device (the VAE's sample noise; in stage 2 also the
modality-dropout groups, the diffusion noise and the timesteps) and the
generator that every step's dropout masks come from, seeded from the
run's seed, then drives the trainer through its first ``checked_steps``
steps, which also warm up every shape.  The window goes on with the same trainer: step i
moves host batch i mod pool pinned and non-blocking (``to_tensors``) and
steps on it; the host never waits inside the window, and the window ends
when the device has finished.

After the window, with ``trace``: three steps with a synchronise around
each half (spans ``grads``, ``optimizer``), then three under the profiler.
Correctness: the checked steps against the fp32 reference's (see
``checks.py``).
"""
from __future__ import annotations

import gc
import time


def _draws(cfg, stage, b, gen, dev):
    import torch

    d = {"eps": torch.randn((2, b, 8, int(cfg["latent_dim"][1])),
                            generator=gen, device=dev)}
    if stage == "vae":
        return d
    # 6 groups of int(uncondp * B) rows drop all but one condition each;
    # the other rows keep every condition (group 6)
    k = int(float(cfg["guidance_uncondp"]) * b)
    perm = torch.randperm(b, generator=gen, device=dev)
    group = torch.full((b,), 6, dtype=torch.long, device=dev)
    group[perm[:6 * k]] = torch.arange(6 * k, device=dev) // max(k, 1)
    tokens = 2 * int(cfg["max_len"]) // 16
    d.update(group=group,
             noise=torch.randn((b, tokens, int(cfg["latent_dim"][1])),
                               generator=gen, device=dev),
             timesteps=torch.randint(
                 0, int(cfg["noise_scheduler"]["num_train_timesteps"]), (b,),
                 generator=gen, device=dev))
    return d


def mask_seed(ctx) -> int:
    """The seed of the generator the steps' dropout masks come from."""
    from perfbench import weights as W

    return W.stream(ctx.seed, 2)


def inputs(ctx, dev):
    """What the benchmark makes from the seed: the weights, the pool of
    host batches and each batch's draws on the device."""
    import torch

    from perfbench import traffic
    from perfbench import weights as W
    from perfbench.reference import model as R

    stage, b = ctx.traffic["stage"], int(ctx.traffic["batch"])
    weights = W.draw(R.param_specs(ctx.cfg, stage), ctx.seed, dev)
    pool = traffic.batches(ctx.traffic, ctx.seed)
    gen = torch.Generator(device=dev).manual_seed(W.stream(ctx.seed, 1))
    return weights, pool, [_draws(ctx.cfg, stage, b, gen, dev)
                           for _ in pool]


def _host_batch(model, raw, stage):
    if stage == "vae":
        return {"motion": raw["motion"]}
    text, _, _ = model.prepare_text_batch(raw["text_spk"], raw["text_lsn"])
    return {**text, "melspec_lsn": raw["mel"],
            "active_passive_lsn": raw["apb"], "lsn_id": raw["lsn_id"],
            "motion_lsn": raw["motion"]}


def run(ctx):
    import torch
    from convofusion_tpu_torch.models.convofusion import Convofusion, \
        to_tensors
    from convofusion_tpu_torch.train.trainer import Trainer

    from perfbench import checks
    from perfbench import trace
    from perfbench.reference.tokenizer import write_spiece

    p = ctx.traffic
    stage, b = p["stage"], int(p["batch"])
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    spiece = write_spiece(f"{ctx.workdir}/spiece.model")
    ctx.cfg["t5_path"] = spiece
    weights, pool, draws = inputs(ctx, dev)
    with torch.device(dev):
        model = Convofusion(ctx.cfg, dtype=ctx.config["compute_dtype"],
                            device=dev, seed=None, stage=stage)
    model.load_state_dict(weights)
    trainer = Trainer(model)
    trainer.init_state()
    host = [_host_batch(model, raw, stage) for raw in pool]
    masks = torch.Generator(device=dev).manual_seed(mask_seed(ctx))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    span = trace.span if ctx.trace else trace.no_span

    def step(i):
        k = i % len(pool)
        with span("to_tensors"):
            batch = to_tensors(host[k], dev)
        with span("compute_grads"):
            loss, _ = trainer.compute_grads(batch, masks, draws[k])
        with span("apply_grads"):
            trainer.apply_grads()
        return loss

    n_checked = int(p["checked_steps"])
    with trainer.training():
        losses = []
        for i in range(n_checked):
            losses.append(step(i))
            if i == 0:
                grad_norms = [n / (1.0 - checks.ADAM_B1) for n in
                              torch._foreach_norm(trainer.state.mu)]
                change1 = {n: m - weights[n].float()
                           for n, m in zip(trainer.names, trainer.masters)}
                # how many bfloat16 weights the first step left as drawn
                same = sum(int((p.detach() == weights[n]).sum())
                           for n, p in zip(trainer.names, trainer.params))
                unchanged1 = same / sum(p.numel() for p in trainer.params)
        change = {n: m - weights[n].float()
                  for n, m in zip(trainer.names, trainer.masters)}
        sync()
        setup_s = time.perf_counter() - ctx.t_start

        i, ends = n_checked, []
        t0 = time.perf_counter()
        while True:
            last = step(i)
            i += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= ctx.seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        steps = i - n_checked
        rec = {"setup_s": setup_s, "window_s": window_s, "attempted": steps,
               "failed": 0, "steps": steps, "train_rows": steps * b,
               "unit_s": [y - x for x, y in zip([0.0] + ends, ends)]}
        if ctx.trace:
            spans = {"grads": [], "optimizer": []}
            for j in range(3):
                batch = to_tensors(host[(i + j) % len(pool)], dev)
                sync()
                t = time.perf_counter()
                trainer.compute_grads(batch, masks,
                                      draws[(i + j) % len(pool)])
                sync()
                spans["grads"].append(time.perf_counter() - t)
                t = time.perf_counter()
                trainer.apply_grads()
                sync()
                spans["optimizer"].append(time.perf_counter() - t)
            rec["spans"] = spans
            rec["trace"] = trace.profiled(
                "pb_window", lambda: [step(i + 3 + j) for j in range(3)],
                ctx.workdir)
            rec["trace_steps"] = 3
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if on_card else 0)
    program = {
        "losses": [float(x) for x in losses],
        "grad_norms": dict(zip(trainer.names, (float(x) for x in
                                                grad_norms))),
        "change1": change1,
        "change": change,
        "window_loss": float(last),
    }
    del model, trainer, host
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["readings"] = checks.train_readings(
        ctx, weights, stage, pool[:n_checked], draws[:n_checked], program,
        spiece, mask_seed(ctx))
    # not compared: the cause of the later steps' gaps (PERF.md)
    rec["diagnostics"] = {"bf16_unchanged_step1": unchanged1}
    rec["check_s"] = time.perf_counter() - t
    return rec
