"""Long-form synthesis: a windowed rollout with latent inpainting.

Port of ``convofusion_tpu/cli/unbounded.py:26-203`` (reference
``unbounded_synthesis.py``): a long batch of ``n_parts`` 128-frame parts
runs as ``2 * n_parts - 1`` half-overlapping windows.  Per window, on the
host: the window's text from the word segments (:189-241 of the
reference), tokenization, the window's mel / active-passive slices and, with
WEG, focus words from the window's non-overlapping half; on the device: the
cached sampler with the previous window's second-half latents inpainted at
every step (``Convofusion.diffusion_reverse(preseq=...)``) and the VAE
decode; then, on the host, the motion's root translation is stitched to
the previous window's (:461-468).  The uncond branch is encoded once, by
the first window: every window has the same geometry.

``main`` is the entry point (``convofusion_tpu/cli/unbounded.py:206-273``):
a YAML config's test split, every batch rolled out on one process, each
window's noise drawn on the host from ``SEED_VALUE`` (JAX's data-parallel
rollout waits for DDP):

    python -m convofusion_tpu_torch.cli.unbounded --cfg <yaml> \\
        [--cfg_assets <yaml>] [--device cpu] [key=value ...]
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

UNCOND = "-" * 10

# The reference rollout does not read cfg weg_parameters: its
# diffusion_reverse_forecast hardcodes its own WEG constants
# (unbounded_synthesis.py:83-88) and re-creates scale_range inside the step
# loop, so its step sizes follow the true linspace decay.
ROLLOUT_WEG_PARAMETERS = dict(
    scale_factor=100, scale_range=[1.0, 0.5],
    thresholds={0: 0.05, 200: 0.4, 400: 0.6, 600: 0.8},
    max_iter_to_alter=800, max_refinement_steps=300,
    scale_schedule="linspace")


def process_text(seg_batch, chunk_tstart: float, chunk_tend: float):
    """Window text from word segments (unbounded_synthesis.py:189-241):
    the words inside the window plus the reference's overlap heuristics at
    its boundaries."""
    out = []
    chunk_len = chunk_tend - chunk_tstart
    mid = (chunk_tstart + chunk_tend) / 2
    for seg_lsn in seg_batch:
        if seg_lsn == UNCOND or seg_lsn is None:
            out.append(UNCOND if seg_lsn == UNCOND else "")
            continue
        words = []
        for s_idx, seg in enumerate(seg_lsn):
            s, e = float(seg[0][0]), float(seg[0][1])
            w = seg[1]
            if s >= chunk_tstart and e <= chunk_tend:
                words.append(w)
            elif (e >= mid and e <= chunk_tend
                  and ((s < (chunk_tstart - chunk_len / 2) and s_idx > 0)
                       or (s < chunk_tstart and s_idx == 0))):
                words.append(w)
            elif (s >= (chunk_tstart - 1) and s < chunk_tstart
                  and e <= (chunk_tend + 1) and e > chunk_tend):
                words.append(w)
            elif (s >= chunk_tstart and s <= mid
                  and e <= (chunk_tend + 1) and e >= chunk_tend):
                words.append(w)
            elif (s <= chunk_tstart and s >= (chunk_tstart - 1)
                  and e >= mid and e <= chunk_tend):
                words.append(w)
            elif s > mid and s <= (chunk_tend - 1) and e <= (chunk_tend + 1):
                words.append(w)
            elif (s >= (chunk_tstart - 1) and e >= (chunk_tstart + 2)
                  and e < mid):
                words.append(w)
        out.append(" ".join(words))
    return out


def rollout(model, batch, generator=None, window_frames: int = 128,
            num_inference_steps: Optional[int] = None, weg_type: str = "no",
            save_dir: Optional[str] = None, verbose: bool = True,
            rng: Optional[random.Random] = None,
            noise: Optional[Sequence[Tuple]] = None) -> List[np.ndarray]:
    """Roll one long batch (numpy arrays and lists, (B, n_parts * 128, ...)
    as ``data/synthetic.synthetic_long_batch`` makes) through its windows.

    ``generator`` draws each window's noise on the model's device, unless
    ``noise`` gives one (init_noise, step_noise) pair a window.  ``rng``
    draws the 'random' WEG focus words (a fresh ``random.Random()`` when
    None).  ``save_dir`` dumps every window's results.  Returns the
    stitched fp32 motion of each window, (B, 128, nfeats) on the host."""
    from convofusion_tpu_torch.cli.focus import select_focus_words
    from convofusion_tpu_torch.models.convofusion import to_tensors
    from convofusion_tpu_torch.models.results import save_generation_results
    from convofusion_tpu_torch.models.tokenizer import focus_word_indices

    # the WEG override rides the cached sampler: the model's own
    # weg_parameters stay as they are
    sampler = model.cached_sampler(
        num_inference_steps,
        ROLLOUT_WEG_PARAMETERS if weg_type != "no" else None)
    if weg_type == "random" and rng is None:
        rng = random.Random()

    motion_len = window_frames
    time_len = motion_len / model.cfg["fps"]
    n_parts = batch["motion_lsn"].shape[1] // motion_len
    n_iters = 2 * n_parts - 1
    mel_len = batch["melspec_lsn"].shape[1] // n_parts
    apb_len = batch["active_passive_lsn"].shape[1] // n_parts
    audio_len = batch["audio_lsn"].shape[1] // n_parts

    preseq = prev = None
    outputs = []
    for chunk_idx in range(n_iters):
        t0 = time.perf_counter()
        t_start = (chunk_idx / 2) * time_len
        t_end = ((chunk_idx / 2) + 1) * time_len
        text_lsn = process_text(batch["seg_lsn"], t_start, t_end)
        text_spk = process_text(batch["seg_spk"], t_start, t_end)
        m0 = int((chunk_idx / 2) * motion_len)
        mel0 = int((chunk_idx / 2) * mel_len)
        apb0 = int((chunk_idx / 2) * apb_len)
        a0 = int((chunk_idx / 2) * audio_len)
        melspec_lsn = batch["melspec_lsn"][:, mel0:mel0 + mel_len + 1, :]
        apb = batch["active_passive_lsn"][:, apb0:apb0 + apb_len]

        text_arrays, _, tb_lsn = model.prepare_text_batch(text_spk,
                                                          text_lsn)
        arrays = to_tensors({"melspec_lsn": melspec_lsn,
                             "active_passive_lsn": apb,
                             "lsn_id": batch["lsn_id"], **text_arrays},
                            model.device)

        # WEG focus words from the window's non-overlapping part
        # (unbounded_synthesis.py:318-319)
        focus, focus_words = None, []
        if weg_type != "no":
            full_text = (text_lsn if chunk_idx == 0 else process_text(
                batch["seg_lsn"], ((chunk_idx + 1) / 2) * time_len, t_end))
            focus_words = select_focus_words(
                weg_type, full_text, batch.get("sem_info"), rng)
            fi, fv = focus_word_indices(
                tb_lsn.word_map(model.tokenizer.wrapped_texts(text_lsn)),
                focus_words)
            if fv.any():
                focus = {"focus_idx": fi, "focus_valid": fv}

        init_noise, step_noise = (None, None) if noise is None \
            else noise[chunk_idx]
        motion, latents = sampler(arrays, generator, focus=focus,
                                  init_noise=init_noise,
                                  step_noise=step_noise, preseq=preseq)
        # the second half of the window's latent tokens feeds the next
        preseq = latents[:, latents.shape[1] // 2:, :]

        motion = motion.float().cpu().numpy()
        if prev is not None:
            # root translation stitching (unbounded_synthesis.py:461-468)
            xz = np.array([1, 0, 1], np.float32)
            motion[:, :, :3] = motion[:, :, :3] - motion[:, :1, :3] * xz
            motion[:, :, :3] = motion[:, :, :3] + prev[:, :1, :3] * xz
        prev = motion[:, motion_len // 2:, :]
        outputs.append(motion)

        if verbose:
            print(f"window {chunk_idx + 1}/{n_iters}: "
                  f"{time.perf_counter() - t0:.2f}s")

        if save_dir is not None:
            names = [f"{n}+{chunk_idx}" for n in batch["name"]]
            save_generation_results(
                save_dir, gt=batch["motion_lsn"][:, m0:m0 + motion_len, :],
                pred=motion, lengths=[motion_len] * len(names), names=names,
                texts_lsn=text_lsn, texts_spk=batch["text_spk"],
                audios_lsn=batch["audio_lsn"][:, a0:a0 + audio_len],
                audios_spk=batch["audio_spk"][:, a0:a0 + audio_len],
                motion_spk=batch["motion_spk"][:, m0:m0 + motion_len, :],
                spk_names=batch.get("spk_name"),
                lsn_names=batch.get("lsn_name"),
                apb=np.asarray(apb), melspec_lsn=melspec_lsn,
                focus_words=focus_words)
    return outputs


@dataclass
class RolloutRun:
    """What ``main`` did: the dump directory, the data modules' build
    seconds, per test batch its size, its rollout's seconds (host clock,
    ending with the last window's motion on the host) and its windows'
    stitched motion (fp32, on the host), and the model's WEG counts."""
    out_dir: str
    build_s: float = 0.0
    batch_sizes: List[int] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)
    windows: List[List[np.ndarray]] = field(default_factory=list)
    weg_counts: object = None


def window_noise(model, batch_size: int, num_steps: int, n_windows: int,
                 gen: torch.Generator) -> List[Tuple]:
    """Each window's (init_noise, step_noise) on the host from ``gen``,
    copied to the model's device once (``cli/test.py``'s draws, a window
    at a time)."""
    from convofusion_tpu_torch.cli.test import _batch_noise

    out = []
    for _ in range(n_windows):
        noise = _batch_noise(model, batch_size, num_steps, gen)
        out.append((noise["init_noise"], noise.get("step_noise")))
    return out


def main(argv: Optional[List[str]] = None) -> RolloutRun:
    """``parse_args('test')`` -> the test data module -> the model with
    128-frame windows in ``TPU.COMPUTE_DTYPE`` -> the t5-base asset drop
    and ``TEST.CHECKPOINTS`` -> :func:`rollout` of every test batch into
    ``<TEST.FOLDER>/<model_type>/<NAME>/unbounded_<TIME>``."""
    from convofusion_tpu_torch.cli.test import setup
    from convofusion_tpu_torch.config import ablation_flag

    # the windows are 128 frames (8 chunks, 16 latent tokens) whatever
    # the dataset's MAX_LEN, which covers the whole recording
    # (unbounded_synthesis.py:545-550); JAX sets max_len and n_chunks
    # after construction (:225-227)
    cfg, logger, datamodule, build_s, model = setup(
        argv, "unbounded", max_len=128, stage="diffusion")
    seed = int(cfg.SEED_VALUE)

    out_dir = os.path.join(
        str(cfg.TEST.FOLDER), str(cfg.model.model_type), str(cfg.NAME),
        "unbounded_" + cfg.TIME)
    run = RolloutRun(out_dir, build_s)
    weg_type = ablation_flag(cfg, "WEG_TYPE")
    num_steps = int(cfg.model.scheduler.get("num_inference_timesteps",
                                            1000))
    noise_gen = torch.Generator().manual_seed(seed)
    focus_rng = random.Random(seed)
    for batch in datamodule.test_dataloader():
        b = len(batch["name"])
        n_windows = 2 * (batch["motion_lsn"].shape[1] // 128) - 1
        noise = window_noise(model, b, num_steps, n_windows, noise_gen)
        t0 = time.perf_counter()
        outs = rollout(model, batch, num_inference_steps=num_steps,
                       weg_type=weg_type, save_dir=out_dir, rng=focus_rng,
                       noise=noise)
        run.seconds.append(time.perf_counter() - t0)
        run.batch_sizes.append(b)
        run.windows.append(outs)
        logger.info(f"{b} rollouts of {n_windows} windows in "
                    f"{run.seconds[-1]:.2f}s")
    run.weg_counts = model.weg_counts
    print(f"results saved to {out_dir}")
    return run


if __name__ == "__main__":
    main()
