"""The training entry point: a YAML config's stage trained epoch by epoch,
validated, logged and checkpointed.

Port of ``convofusion_tpu/cli/train.py:19-413`` (reference train.py),
single process on one device: ``parse_args('train')`` -> ``create_logger``
and ``MetricsLogger`` -> ``get_datasets`` -> the model of ``TRAIN.STAGE``
in ``TPU.COMPUTE_DTYPE`` (bf16 by default; fp32 masters in the
``Trainer``) -> the t5-base asset drop -> ``TRAIN.RESUME`` (the latest
``epoch=<n>.ckpt`` of ``<FOLDER_EXP>/checkpoints``: weights, optimizer
state and the loss generator) or, for a stage other than 'vae',
``TRAIN.PRETRAINED_VAE`` through ``transplant_vae`` -> the epoch loop.

    python -m convofusion_tpu_torch.cli.train --cfg <yaml> \\
        [--cfg_assets <yaml>] [--device cpu] [key=value ...]

Per epoch: ``train_dataloader(seed=epoch)`` through ``prefetch`` (depth
``TPU.PREFETCH``, default 2), a Trainer step a batch, the terms averaged
over finite steps with one copy to the host (``aggregate_terms``); every
``LOGGER.VAL_EVERY_STEPS`` epochs the loss over ``val_dataloader()`` in
eval mode with no grad, logged as ``*/val``; ``metrics.jsonl`` and the
progress line; a background checkpoint every
``LOGGER.SACE_CHECKPOINT_EPOCH`` epochs, at the last epoch and on
preemption.

Host-side caches of the frozen encoders (both built after the weights are
loaded, from private copies in eval mode that the training step never
toggles; their encodes run under no_grad on the prefetch thread):

* ``TPU.CACHE_TEXT_TRUNK`` (default on, not in stage 'vae'): the T5 trunk's
  states per text (``TextEmbeddingCache``, the uncond row at batch 1) in
  place of token ids (JAX :128-157).  Misses are encoded unpadded.
* ``TPU.CACHE_VAE_POSTERIOR`` (default on, stage 'diffusion' only): the
  VAE's (mu, logvar) per content key (the name and the SHA-1 of the whole
  motion row), the whole batch encoded once on a miss, cleared at
  ``TPU.VAE_POSTERIOR_CACHE_CAP`` entries (default 16384; JAX :167-213).

Randomness: each step's draws (the VAE's eps, the modality-dropout groups,
the diffusion noise and timesteps) come from a host generator seeded with
``SEED_VALUE + epoch`` inside ``prepare`` and reach the step as ``draws``,
so the card and the CPU see the same draws and a resumed epoch draws what
a straight run's does (JAX splits one key from ``SEED_VALUE`` and starts it
again on resume).  Dropout masks come from the loss generator, seeded with
``SEED_VALUE`` on the device and saved with each checkpoint.

A SIGTERM (``TPU.PREEMPTION_CHECKPOINT``, default on) ends the epoch at the
next step: the partial epoch is logged and checkpointed under its number,
and ``main`` returns.  ``TPU.MULTIHOST`` raises: multi-host (DDP) training
is not ported.
"""
from __future__ import annotations

import copy
import hashlib
import os
import signal
import threading
import time
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from convofusion_tpu_torch.models.text_cache import TextEmbeddingCache


@dataclass
class TrainStats:
    """What ``main`` did, attached to the returned model as
    ``model.train_stats``: the data module's build seconds, the train
    split's items, the first epoch, and per epoch the steps, the
    seconds of the step loop (ending in the terms' copy to the
    host, which waits for the card) and of it until the first batch was
    ready, the prefetch thread's seconds in the loader and in ``prepare``,
    the step loop's seconds waiting for a batch after the first, and the
    caches' hits and misses so far."""
    build_s: float = 0.0
    train_items: int = 0
    start_epoch: int = 0
    epochs: List[Dict] = field(default_factory=list)


def build_model(cfg, dtype: str, device):
    """The model of ``TRAIN.STAGE`` with weights seeded from
    ``SEED_VALUE``."""
    from convofusion_tpu_torch.config import from_cfg
    from convofusion_tpu_torch.models.convofusion import Convofusion

    return Convofusion(from_cfg(cfg), dtype=dtype, device=device,
                       seed=int(cfg.SEED_VALUE), stage=str(cfg.TRAIN.STAGE))


def step_draws(model, batch_size: int, nframes: int,
               gen: torch.Generator) -> Dict:
    """One step's draws on the host from ``gen``, in the layout of
    ``Trainer.compute_grads(draws=)``: 'eps' for stage 1; 'eps', 'group',
    'noise' and 'timesteps' for stage 2; both under 'vae' and 'diffusion'
    for the joint stage."""
    eps = torch.randn(model._posterior_shape(batch_size, nframes),
                      generator=gen)
    if model.stage == "vae":
        return {"eps": eps}
    diffusion = {
        "eps": eps,
        "group": model._dropout_groups(batch_size, gen, "cpu"),
        "noise": torch.randn((batch_size, model.latent_tokens,
                              model.latent_dim), generator=gen),
        "timesteps": torch.randint(
            0, model.noise_scheduler.num_train_timesteps, (batch_size,),
            generator=gen),
    }
    if model.stage == "vae_diffusion":
        return {"vae": {"eps": torch.randn(eps.shape, generator=gen)},
                "diffusion": diffusion}
    return diffusion


def _timed(iterable, clock: Dict, key: str):
    """Yield from ``iterable``, adding each ``next``'s seconds to
    ``clock[key]``."""
    it = iter(iterable)
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            clock[key] += time.perf_counter() - t
        yield item


def _to_device(tree, device):
    """Host tensors (nested dicts) to ``device``: from pinned memory
    without blocking the host on the card."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if device.type == "cuda":
        return tree.pin_memory().to(device, non_blocking=True)
    return tree.to(device)


class TrunkCache:
    """Host cache of the frozen T5 trunk's states (JAX :128-157) over a
    private eval-mode copy of the trunk."""

    def __init__(self, model):
        from convofusion_tpu_torch.models.tokenizer import UNCOND_TEXT

        self.model = model
        self.text_model = copy.deepcopy(model.text_encoder.text_model).eval()
        self.text_model.requires_grad_(False)
        self.cache = TextEmbeddingCache()
        self.uncond = UNCOND_TEXT

    def encode(self, texts: List[str]):
        """(trunk (M, T, d) fp32, mask (M, T) bool) of ``texts``, one
        encode of the unpadded batch."""
        from convofusion_tpu_torch.models.convofusion import to_tensors

        tb = self.model.tokenize(texts)
        t = to_tensors({"ids": tb.input_ids, "mask": tb.attention_mask},
                       self.model.device)
        with torch.no_grad():
            trunk = self.text_model(t["ids"], t["mask"])
        return trunk.float().cpu().numpy(), np.asarray(tb.attention_mask)

    def arrays(self, texts_spk, texts_lsn) -> Dict[str, np.ndarray]:
        pad = self.model.text_pad_len
        out = {}
        for who, texts in (("spk", texts_spk), ("lsn", texts_lsn),
                           ("uncond", [self.uncond])):
            out[f"{who}_trunk"], out[f"{who}_tmask"] = \
                self.cache.encode_batch(list(texts), pad, self.encode)
        return out


class PosteriorCache:
    """Host cache of the frozen VAE's (mu, logvar) per content key (JAX
    :167-213) over a private eval-mode copy of the VAE."""

    def __init__(self, model, cap: int = 16384):
        self.model = model
        self.vae = copy.deepcopy(model.vae).eval()
        self.vae.requires_grad_(False)
        self.cap = cap
        self.cache: Dict[str, tuple] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(name: str, motion_row: np.ndarray) -> str:
        # the content, not just the name: a multi-listener entry picks a
        # random listener each epoch (data/dataset.py), so one name can
        # carry different motion; the whole row is hashed, since a sampled
        # hash could alias two motions to one posterior
        dig = hashlib.sha1(
            np.ascontiguousarray(motion_row).tobytes()).hexdigest()[:16]
        return f"{name}|{dig}"

    def __call__(self, names, motion: np.ndarray):
        from convofusion_tpu_torch.models.convofusion import vae_posterior

        motion = np.asarray(motion)
        keys = [self.key(n, motion[i]) for i, n in enumerate(names)]
        missing = sum(k not in self.cache for k in keys)
        self.hits += len(keys) - missing
        self.misses += missing
        if missing:
            # the whole batch in one encode; each row kept
            x = torch.from_numpy(np.ascontiguousarray(motion)).to(
                self.model.device)
            mu, lv = vae_posterior(self.vae, x)
            mu, lv = mu.float().cpu().numpy(), lv.float().cpu().numpy()
            if len(self.cache) + len(keys) > self.cap:
                self.cache.clear()
            for i, k in enumerate(keys):
                self.cache[k] = (mu[i], lv[i])
        return (np.stack([self.cache[k][0] for k in keys]),
                np.stack([self.cache[k][1] for k in keys]))


def main(argv: Optional[List[str]] = None):
    """Train ``TRAIN.STAGE`` from ``START_EPOCH`` (or the resumed epoch)
    to ``END_EPOCH``; returns the model (``model.train_stats``: see
    :class:`TrainStats`)."""
    from convofusion_tpu_torch.callback.progress import ProgressLogger
    from convofusion_tpu_torch.cli.test import compute_dtype
    from convofusion_tpu_torch.config import parse_args
    from convofusion_tpu_torch.data.datamodule import get_datasets
    from convofusion_tpu_torch.models.convofusion import to_tensors
    from convofusion_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        maybe_load_t5_assets,
        save_checkpoint,
        transplant_vae,
        wait_for_checkpoints,
    )
    from convofusion_tpu_torch.train.prefetch import prefetch
    from convofusion_tpu_torch.train.trainer import Trainer
    from convofusion_tpu_torch.utils.logger import create_logger
    from convofusion_tpu_torch.utils.metrics_logger import (
        MetricsLogger,
        aggregate_terms,
    )

    pre = ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="e.g. cpu (default: the card)")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args("train", rest)
    tpu = cfg.get("TPU", {}) or {}
    if bool(tpu.get("MULTIHOST", False)):
        raise NotImplementedError(
            "TPU.MULTIHOST=True: multi-host (DDP) training is not ported; "
            "this entry point trains on one device")
    seed = int(cfg.SEED_VALUE)
    stage = str(cfg.TRAIN.STAGE)
    logger = create_logger(cfg, "train")
    metrics = MetricsLogger(
        cfg.FOLDER_EXP,
        enable_wandb=not bool(cfg.LOGGER.WANDB.get("OFFLINE", True)),
        wandb_project=cfg.LOGGER.WANDB.get("PROJECT"),
        wandb_resume_id=cfg.LOGGER.WANDB.get("RESUME_ID"))
    logger.info(f"stage={stage} name={cfg.NAME}")

    stats = TrainStats()
    t0 = time.perf_counter()
    datamodule = get_datasets(cfg)[0]
    stats.train_items = len(datamodule.dataset("train"))
    stats.build_s = time.perf_counter() - t0

    model = build_model(cfg, compute_dtype(cfg), known.device)
    dev = model.device
    trainer = Trainer(model)
    # real t5-base trunk weights from the asset drop (utils/assets.py),
    # as the reference's from_pretrained; checkpoints leave the trunk out
    maybe_load_t5_assets(model)
    # dropout masks; saved with every checkpoint
    gen = torch.Generator(device=dev).manual_seed(seed)

    ckpt_dir = os.path.join(cfg.FOLDER_EXP, "checkpoints")
    start_epoch = int(cfg.TRAIN.START_EPOCH)
    resume = latest_checkpoint(ckpt_dir) if cfg.TRAIN.RESUME else None
    if resume:
        logger.info(f"resuming from {resume}")
        load_checkpoint(resume, model, trainer, gen)
        # epoch=<n>.ckpt -> n + 1
        start_epoch = int(os.path.basename(resume).split("=")[1].split(
            ".")[0]) + 1
    else:
        if cfg.TRAIN.PRETRAINED_VAE and stage != "vae":
            logger.info(f"loading pretrained VAE {cfg.TRAIN.PRETRAINED_VAE}")
            transplant_vae(model, str(cfg.TRAIN.PRETRAINED_VAE))
        trainer.init_state()
    stats.start_epoch = start_epoch
    model.train_stats = stats

    tcache = pcache = None
    if stage != "vae" and bool(tpu.get("CACHE_TEXT_TRUNK", True)):
        # the config system raises on a text-encoder dropout other than 0,
        # JAX's third condition
        tcache = TrunkCache(model)
        logger.info("frozen-T5 trunk cache enabled (TPU.CACHE_TEXT_TRUNK)")
    if stage == "diffusion" and bool(tpu.get("CACHE_VAE_POSTERIOR", True)):
        # strictly stage 2: in 'vae_diffusion' the VAE trains
        pcache = PosteriorCache(
            model, int(tpu.get("VAE_POSTERIOR_CACHE_CAP", 16384)))
        logger.info(
            "frozen-VAE posterior cache enabled (TPU.CACHE_VAE_POSTERIOR)")
    trunk_dtype = (None if stage == "vae"
                   else model.text_encoder.projection[1].weight.dtype)

    def prepare(batch, draw_gen):
        """One loader batch -> (arrays, draws) on the device; runs on the
        prefetch thread."""
        motion = batch["motion" if stage == "vae" else "motion_lsn"]
        draws = _to_device(step_draws(model, motion.shape[0],
                                      motion.shape[1], draw_gen), dev)
        if stage == "vae":
            return to_tensors({"motion": motion}, dev), draws
        arrays = {k: batch[k] for k in ("melspec_lsn", "active_passive_lsn",
                                        "lsn_id")}
        if pcache is not None:
            arrays["vae_mu"], arrays["vae_logvar"] = pcache(
                list(batch["name"]), motion)
        else:
            arrays["motion_lsn"] = motion
        if tcache is not None:
            # the cache carries its masks: no tokenizer run and no ids; the
            # uncond row stays (1, T, d), broadcast inside the step
            arrays.update(tcache.arrays(batch["text_spk"],
                                        batch["text_lsn"]))
        else:
            arrays.update(model.prepare_text_batch(
                batch["text_spk"], batch["text_lsn"])[0])
        out = to_tensors(arrays, dev)
        for k in ("spk_trunk", "lsn_trunk", "uncond_trunk"):
            if k in out:
                out[k] = out[k].to(trunk_dtype)
        return out, draws

    depth = int(tpu.get("PREFETCH", 2))
    save_every = int(cfg.LOGGER.SACE_CHECKPOINT_EPOCH)
    val_every = int(cfg.LOGGER.get("VAL_EVERY_STEPS", 0) or 0)
    end_epoch = int(cfg.TRAIN.END_EPOCH)
    progress = ProgressLogger(logger)

    # preemption: a SIGTERM flag checked after each step (single process;
    # JAX's multi-host sync manager waits for DDP)
    sigterm = []
    previous_handler = None
    if bool(tpu.get("PREEMPTION_CHECKPOINT", True)) and \
            threading.current_thread() is threading.main_thread():
        previous_handler = signal.signal(
            signal.SIGTERM, lambda signum, frame: sigterm.append(True))

    global_step = 0
    stop = False
    try:
        for epoch in range(start_epoch, end_epoch):
            draw_gen = torch.Generator().manual_seed(seed + epoch)
            loader = datamodule.train_dataloader(seed=epoch)
            terms = []
            # host seconds: the loader and prepare on the prefetch thread,
            # the step loop's waits for a batch
            clock = {"loader_s": 0.0, "prepare_s": 0.0, "wait_s": 0.0}

            def timed_prepare(b):
                t = time.perf_counter()
                try:
                    return prepare(b, draw_gen)
                finally:
                    clock["prepare_s"] += time.perf_counter() - t

            t0 = time.perf_counter()
            batches = prefetch(_timed(loader, clock, "loader_s"),
                               timed_prepare, depth=depth, device=dev)
            first_s = 0.0
            with trainer.training():
                t_wait = t0
                for arrays, draws in batches:
                    if not terms:
                        # the first batch is prepared with nothing to hide
                        # it behind
                        first_s = time.perf_counter() - t0
                    else:
                        clock["wait_s"] += time.perf_counter() - t_wait
                    _, step_terms = trainer.compute_grads(arrays, gen, draws)
                    trainer.apply_grads()
                    terms.append(step_terms)
                    global_step += 1
                    t_wait = time.perf_counter()
                    if sigterm:
                        logger.info(
                            f"preemption signal at epoch {epoch} step "
                            f"{global_step}: checkpointing and exiting")
                        stop = True
                        break
            batches.close()
            epoch_metrics = aggregate_terms(terms, "train")
            seconds = time.perf_counter() - t0
            logger.info(
                f"epoch {epoch}: loss="
                f"{epoch_metrics.get('total/train', float('nan')):.4f} "
                f"({seconds:.1f}s, {len(terms)} steps)")
            epoch_metrics["epoch_seconds"] = seconds

            if val_every and (epoch + 1) % val_every == 0 and not stop:
                val_terms = []
                with torch.no_grad():
                    for arrays, draws in prefetch(
                            datamodule.val_dataloader(),
                            lambda b: prepare(b, draw_gen), depth=depth,
                            device=dev):
                        _, vt = trainer.loss_fn()(arrays, gen, draws)
                        val_terms.append(vt)
                val_metrics = aggregate_terms(val_terms, "val")
                if val_metrics:
                    logger.info(
                        f"epoch {epoch}: val loss="
                        f"{val_metrics.get('total/val', float('nan')):.4f}")
                    epoch_metrics.update(val_metrics)
            # the caches' totals after the epoch's training and validation
            row = {"epoch": epoch, "steps": len(terms), "seconds": seconds,
                   "first_batch_s": first_s, **clock}
            for name, c in (("trunk", tcache and tcache.cache),
                            ("posterior", pcache)):
                if c is not None:
                    row[f"{name}_hits"], row[f"{name}_misses"] = \
                        c.hits, c.misses
                    logger.info(f"{name} cache: {c.hits} hits, "
                                f"{c.misses} misses")
            stats.epochs.append(row)
            metrics.log(epoch_metrics, step=epoch)
            progress.on_epoch_end(epoch, epoch_metrics)
            if (epoch + 1) % save_every == 0 or epoch == end_epoch - 1 \
                    or stop:
                # the tensors are on the host when this returns; a thread
                # writes the file while the next epoch runs
                path = save_checkpoint(ckpt_dir, epoch, model,
                                       trainer=trainer, generator=gen,
                                       background=True)
                logger.info(f"saving {path} (async)")
            if stop:
                break
        wait_for_checkpoints()
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
        metrics.close()
    return model


if __name__ == "__main__":
    # main() returns the trained model for callers and tests, not an exit
    # status
    main()
