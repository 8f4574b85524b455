"""The test (generation) entry point: a YAML config's test split through the
model, into per-sample result directories.

Port of ``convofusion_tpu/cli/test.py:18-205`` (reference test.py):
``parse_args('test')`` -> ``create_logger`` -> ``get_datasets`` -> the
model on the device, in ``TPU.COMPUTE_DTYPE`` (base.yaml:122, bf16) ->
the t5-base asset drop, then ``TEST.CHECKPOINTS`` (a reference-format
``.ckpt`` / ``.pt`` / ``.pth`` / ``.bin`` through ``load_torch_full_model``,
else ``load_checkpoint``) -> a cached sampler -> per batch: tokenize, focus
words by ``TRAIN.ABLATION.WEG_TYPE``, ``sample()`` (DDPM/DDIM launch the
fused step kernel once a step) -> ``save_generation_results``, or
``save_vae_results`` for the 'vae' stage.  With ``TEST.SAVE_PREDICTIONS``
the sampler captures every step's full-condition attention maps.

    python -m convofusion_tpu_torch.cli.test --cfg <yaml> \\
        [--cfg_assets <yaml>] [--device cpu] [key=value ...]

The device is the card unless ``--device`` names another; with no card
and no ``--device`` it raises.  Each batch's noise is drawn on the host
from a CPU generator seeded with ``SEED_VALUE`` and copied to the device
once, so a run on the card and one on the CPU sample from the same noise
(JAX draws its own from keys).  JAX's multi-device sampling
(``local_data_parallel``) and its multi-host barrier have no counterpart:
this entry point runs one process on one device.  JAX's test CLI ignores
``TPU.COMPUTE_DTYPE`` and computes in fp32 unless a module sets its own
``compute_dtype``; pass ``TPU.COMPUTE_DTYPE=float32`` for its numerics.
"""
from __future__ import annotations

import os
import random
import time
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@dataclass
class TestRun:
    """What ``main`` did: the result directory, the data modules' build
    time, and per batch the loader's, the tokenizer's and the sampler's
    milliseconds (host clock; the sampler's ends in a device sync), the
    batch size and the final latents (fp32, on the host)."""
    out_dir: str
    build_s: float = 0.0
    loader_ms: List[float] = field(default_factory=list)
    tokenize_ms: List[float] = field(default_factory=list)
    sample_ms: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    latents: List[np.ndarray] = field(default_factory=list)


def compute_dtype(cfg) -> str:
    """``TPU.COMPUTE_DTYPE``, 'float32' where the config has none."""
    tpu = cfg.get("TPU", {}) or {}
    return str(tpu.get("COMPUTE_DTYPE", "float32"))


def setup(argv: Optional[List[str]], log_name: str,
          max_len: Optional[int] = None, stage: Optional[str] = None):
    """The generation entry points' start: ``--device`` and
    ``parse_args('test')``, the logger, the test data module (timed), then
    the model of ``stage`` (default ``TRAIN.STAGE``) in
    ``TPU.COMPUTE_DTYPE``, ``max_len`` replacing the config's, with the
    t5-base asset drop and ``TEST.CHECKPOINTS`` loaded.  Returns (cfg,
    logger, datamodule, build_s, model)."""
    from convofusion_tpu_torch.config import from_cfg, parse_args
    from convofusion_tpu_torch.data.datamodule import get_datasets
    from convofusion_tpu_torch.models.convofusion import Convofusion
    from convofusion_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_torch_full_model,
        maybe_load_t5_assets,
    )
    from convofusion_tpu_torch.utils.logger import create_logger

    pre = ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="e.g. cpu (default: the card)")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args("test", rest)
    logger = create_logger(cfg, log_name)

    t0 = time.perf_counter()
    datamodule = get_datasets(cfg, phase="test")[0]
    datamodule.dataset("test")
    build_s = time.perf_counter() - t0

    model_cfg = from_cfg(cfg)
    if max_len is not None:
        model_cfg["max_len"] = max_len
    model = Convofusion(model_cfg, dtype=compute_dtype(cfg),
                        device=known.device, seed=int(cfg.SEED_VALUE),
                        stage=stage or str(cfg.TRAIN.STAGE))
    # a checkpoint leaves the frozen T5 trunk out: the asset drop's real
    # t5-base weights go in first (utils/assets.py)
    maybe_load_t5_assets(model)
    ckpt = str(cfg.TEST.CHECKPOINTS)
    if ckpt:
        if ckpt.endswith((".ckpt", ".pt", ".pth", ".bin")):
            load_torch_full_model(ckpt, model)
        else:
            load_checkpoint(ckpt, model)
        logger.info(f"loaded checkpoint {ckpt}")
    return cfg, logger, datamodule, build_s, model


def main(argv: Optional[List[str]] = None) -> TestRun:
    from convofusion_tpu_torch.cli.focus import select_focus_words
    from convofusion_tpu_torch.config import ablation_flag
    from convofusion_tpu_torch.models.results import (
        save_generation_results,
        save_vae_results,
    )
    from convofusion_tpu_torch.models.tokenizer import focus_word_indices

    cfg, logger, datamodule, build_s, model = setup(argv, "test")
    seed = int(cfg.SEED_VALUE)
    stage = str(cfg.TRAIN.STAGE)
    on_card = model.device.type == "cuda"

    out_dir = os.path.join(
        str(cfg.TEST.FOLDER), str(cfg.model.model_type), str(cfg.NAME),
        "samples_" + cfg.TIME)
    run = TestRun(out_dir, build_s)
    weg_type = ablation_flag(cfg, "WEG_TYPE")
    save = bool(cfg.TEST.SAVE_PREDICTIONS)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    noise_gen = torch.Generator().manual_seed(seed)
    focus_rng = random.Random(seed)

    timer = None
    if bool(cfg.TEST.get("COUNT_TIME", False)):
        from convofusion_tpu_torch.utils.profiling import SampleTimer

        timer = SampleTimer(int(cfg.TEST.BATCH_SIZE), cfg.FOLDER_EXP,
                            log=logger.info)
    if stage != "vae":
        num_steps = int(cfg.model.scheduler.get("num_inference_timesteps",
                                                1000))
        sampler = model.cached_sampler(
            num_inference_steps=num_steps,
            capture_attention="all" if save else "none")

    batches = iter(datamodule.test_dataloader())
    while True:
        t_load = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        run.loader_ms.append((time.perf_counter() - t_load) * 1e3)
        run.batch_sizes.append(len(batch["length"]))
        if timer:
            timer.start()
        t_start = time.perf_counter()
        if stage == "vae":
            motion = torch.from_numpy(batch["motion"]).to(model.device)
            with torch.no_grad():
                latent, _, _ = model.vae.encode(motion, generator=gen)
                recon = model.vae.decode(latent, motion.shape[1])
            if save:
                save_vae_results(out_dir, batch["motion"],
                                 recon.float().cpu().numpy(),
                                 batch["length"], batch["name"])
            run.sample_ms.append((time.perf_counter() - t_start) * 1e3)
            continue

        arrays, tb_spk, tb_lsn = _prepare(model, batch, run)
        focus = None
        focus_words = []
        if weg_type != "no":
            focus_words = select_focus_words(
                weg_type, batch["text_lsn"], batch.get("sem_info"),
                rng=focus_rng)
            wrapped = model.tokenizer.wrapped_texts(batch["text_lsn"])
            fi, fv = focus_word_indices(tb_lsn.word_map(wrapped),
                                        focus_words)
            if fv.any():
                focus = {"focus_idx": fi, "focus_valid": fv}

        noise = _batch_noise(model, len(batch["length"]), num_steps,
                             noise_gen)
        t_sample = time.perf_counter()
        motion, latents, *att = sampler(arrays, focus=focus, **noise)
        if on_card:
            torch.cuda.synchronize()
        run.sample_ms.append((time.perf_counter() - t_sample) * 1e3)
        run.latents.append(latents.cpu().numpy())
        if timer:
            timer.stop()
        logger.info(f"gen time: {time.perf_counter() - t_start:.2f}s for "
                    f"{len(batch['length'])} samples")

        if save:
            wrapped_lsn = model.tokenizer.wrapped_texts(batch["text_lsn"])
            wrapped_spk = model.tokenizer.wrapped_texts(batch["text_spk"])
            word_maps = {
                "lsn": tb_lsn.word_map(wrapped_lsn),
                "spk": tb_spk.word_map(wrapped_spk),
            }
            # one copy of the captured maps to the host, after the loop
            att_maps = {s: a.float().cpu().numpy()
                        for s, a in att[0].items()}
            save_generation_results(
                out_dir,
                gt=batch["motion_lsn"], pred=motion.float().cpu().numpy(),
                lengths=batch["length"], names=batch["name"],
                texts_lsn=batch["text_lsn"], texts_spk=batch["text_spk"],
                audios_lsn=batch.get("audio_lsn"),
                audios_spk=batch.get("audio_spk"),
                motion_spk=batch.get("motion_spk"),
                spk_names=batch.get("spk_name"),
                lsn_names=batch.get("lsn_name"),
                apb=batch.get("active_passive_lsn"),
                melspec_lsn=batch.get("melspec_lsn"),
                att_maps=att_maps,
                att_timesteps=model.scheduler.timesteps(num_steps),
                word_maps=word_maps, focus_words=focus_words,
                sem_lsn=batch.get("sem_lsn"),
                sem_info=batch.get("sem_info"),
            )
    if run.sample_ms:
        logger.info(f"mean time/batch: {np.mean(run.sample_ms) / 1e3:.2f}s "
                    f"over {len(run.sample_ms)}")
    if timer:
        timer.dump()
    print(f"results saved to {out_dir}")
    return run


def _batch_noise(model, b: int, num_steps: int, gen: torch.Generator):
    """A batch's initial noise and (except for DPM-Solver++, which draws
    none) every step's, drawn on the host and copied to the model's device
    once, from pinned memory on the card."""
    shape = (b, model.latent_tokens, model.latent_dim)
    noise = {"init_noise": torch.randn(shape, generator=gen)}
    if model.scheduler.variant != "dpmpp_2m":
        noise["step_noise"] = torch.randn((num_steps,) + shape,
                                          generator=gen)
    dev = model.device
    if dev.type == "cuda":
        return {k: v.pin_memory().to(dev, non_blocking=True)
                for k, v in noise.items()}
    return noise


def _prepare(model, batch, run: TestRun):
    """Tokenize (timed into ``run.tokenize_ms``) and move the batch's
    sampler inputs to the model's device."""
    from convofusion_tpu_torch.models.convofusion import to_tensors

    t0 = time.perf_counter()
    text_arrays, tb_spk, tb_lsn = model.prepare_text_batch(
        batch["text_spk"], batch["text_lsn"])
    run.tokenize_ms.append((time.perf_counter() - t0) * 1e3)
    arrays = {
        "melspec_lsn": batch["melspec_lsn"],
        "active_passive_lsn": batch["active_passive_lsn"],
        "lsn_id": batch["lsn_id"],
        **text_arrays,
    }
    return to_tensors(arrays, model.device), tb_spk, tb_lsn


if __name__ == "__main__":
    main()
