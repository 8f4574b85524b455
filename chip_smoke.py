#!/usr/bin/env python3
"""Drive the PyTorch port of ConvoFusion on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--phases 1-3,13]

Phases, each raising on failure (non-zero exit, no result line); --phases
picks some (default all; 1-3 always run, and one phase that launches the
step kernel must be among them):
  1. device  - require CUDA; print the card's name and power limit; TF32 off
  2. build   - nvcc the hand-written kernels from convofusion_tpu_torch/csrc
               (the guided step, AdamW, the guided cross-attention, the
               guided LayerNorm), side by side
  3. kernel  - at the main path's B=96 shapes (latents (96, 16, 128) and,
               for raw motion, (96, 128, 189)) and at the batches the other
               path phases give it (PATH_BATCHES, RAW_MOTION_BATCHES), every
               kernel against its plain PyTorch version on the card
               (DDPM mid, DDPM final, DDIM; fp32 and bf16 branch planes),
               max |diff| <= 1e-5;
               at B=96 CUDA-event times of kernel (L2 flushed, and back to back)
               and plain version; then the step kernel's tile and block
               size sweep at the main path's case (bf16 planes, DDIM);
               the guided cross-attention kernel, through
               grouped_cross_attend, against its plain version for every
               stream at (7, B, Tq, 512) with B 32, 1 and 96, Tq 16 and
               128 and batch-1 and batch-B uncond K/V (relative RMS <= 1e-2
               on the output and the weights), both against an fp64
               witness with the plain version's bf16 rounding points
               (relative RMS, share of elements that differ, bf16 ulps
               away from zero), a CUDA graph's replay bit-equal to the
               eager call, and at (7, 32, 16, 512) CUDA-event times of
               kernel and plain version, each replayed from a CUDA graph,
               against the byte bound, per stream and a layer's five;
               the guided LayerNorm kernel, through normalize, against
               its plain version at every geometry of the guided calls at
               (B, Tq) of LN_BATCHES (at most 1 bf16 ulp on at most 0.1%
               of the elements), a CUDA graph's replay bit-equal to the
               eager call, and at batch 32 CUDA-event times of kernel,
               plain version and F.layer_norm + cast, each replayed from
               a CUDA graph, against the byte bound, per norm and a
               layer's 15
  4. parity  - production geometry, fp32, batch 2, DDIM-20, seeded weights,
               numpy-made inputs and noise: sample() on the card (through
               the kernel) against sample() on the CPU (plain version)
  5. main    - production geometry, bf16, batch 96, DDIM-50, 7-way
               guidance through Convofusion.sample: one warm-up and two
               timed calls; (96, 128, 189) finite motion, exactly 50
               kernel launches and 50 replays of the guided denoiser's
               CUDA graph per call (one capture); 45 cross-attention
               launches in the capture's warm-up and 45 in the capture,
               none in a replay, none of the plain version; 136 LayerNorm
               launches in each of the two and none in a replay, none of
               the plain version; clips/s,
               ms/call, peak memory; at batch 32 and 96 the graphed sample() against
               the eager guided loop from one noise, bit-equal;
               one call split into encode / reverse / decode, and a
               profile of a few reverse steps, which gives the step
               kernel's device time inside the loop (in_path_us)
  6. weg_parity - production geometry, fp32, batch 2, DDIM-5, word-
               excitation guidance (WEG) with focus words on both rows,
               numpy-made inputs and noise: sample(focus=...) on the card
               against the CPU, with the config's WEG parameters and with
               the refinement forced at step 0; refinement iterations and
               text-only passes must be equal on both sides, and each case
               runs twice on the card, bit-equal (a deterministic WEG
               gradient); then one WEG step's ms and kernels with the
               deterministic forms and with the earlier gather forms
  7. serve   - production geometry, bf16, batch 96, DDIM-50, WEG on,
               through build_service and GestureService: 96 requests
               from client threads (most with 1-3 focus words of their own
               text), a few more through serve_http on a loopback port;
               (128, 189) finite motion for every request, exactly 50
               kernel launches per micro-batch; batch ms, requests/s,
               latency p50/p95, occupancy, peak memory, WEG counts per
               batch; then one direct sample() call on one assembled batch
               with focus and one without, for WEG's own cost and the
               pipeline's
  8. rollout_parity - production geometry, fp32, the long-form rollout
               (cli/unbounded.rollout) of a 2-part batch of 2 (3 windows),
               DDIM-4, numpy-made noise for every window: the card
               against the CPU without WEG and with 'random' WEG (one
               seeded random.Random a side); every window's motion and
               latents within their tolerances, root xz continuity between
               windows, exactly 4 kernel launches a window on the card,
               equal WEG counts on both sides
  9. rollout - production geometry, bf16, batch 96, 2 parts (3 windows;
               bench.py --mode rollout has 3 parts), DDIM-50: one warm-up
               of 1 part (1 window) and one timed rollout without WEG, one
               of 1 part with 'random' WEG; finite (96, 128, 189) motion
               for every window, exactly 50 kernel launches a window, one
               uncond encode a sampler (the
               first window of its first rollout); windows/s, ms a window,
               the host's ms a window (window text, tokenization, focus
               words, stitching) against the sampler's, peak memory; then
               the last window's sample() alone, with and without its
               preseq
 10. dpmpp    - production geometry, DPM-Solver++ 2M at 20 steps: fp32
               batch 2 on the card against the CPU, then bf16 batch 96,
               one warm-up and two timed calls (clips/s, ms/call); the
               fused step kernel is never launched (JAX's gate); after the
               count is read, DDIM-20 and dpmpp_2m-20 in turns on that model
 11. train_parity - production geometry, fp32, batch 4, seeded weights,
               dropout 0, numpy-made draws fed to both devices: stage 1
               (the VAE) and stage 2 (token ids) through the Trainer on the
               card against the CPU: step 1's loss and every gradient, the
               losses of 3 AdamW steps; the frozen subtrees (T5 trunk, and
               the VAE in stage 2) bit-identical on the card after them
 12. train    - production geometry, bf16 compute with fp32 master weights:
               stage 2 at batch 64 with token ids, stage 2 at batch 64 with
               the cached T5 trunk and VAE posterior (bench.py --cached-text
               --cached-vae), stage 1 at batch 128; each 3 warm-up and 6
               timed steps (median ms a step, clips/s; replayed from the
               training step's two CUDA graphs from the second step on, the
               graph counters printed), peak memory, 3 graphed steps against
               3 eager ones from one state (losses and masters bit-equal,
               one replay of each graph a step), 2 profiled eager steps
               (kernels a step, the card's busy share against the graphed
               median step), and one profiled eager step with F.dropout's
               fused kernel (the kernels that masks from the step's
               generator add); every loss finite; the AdamW kernel:
               adamw.launches 1 an eager step and none a replay, one
               kernel in the optimizer graph (two profiled steps) and its
               time there; at stage 2 with ids and at stage 1, after the
               peak memory is read, the kernel against the plain foreach
               chain over 4 steps of the stage's whole trainable set from
               the trainer's state (clip off, clip with its own norm, clip
               with a given norm; every 7th gradient absent): masters,
               moments and weights bit-equal, or within 4 fp32 ulps and
               one bf16 ulp, the op that differs named; and CUDA-event
               times back to back of the kernel (a chunk sweep), of the
               plain chain replayed from one CUDA graph and of
               torch._fused_adamw_ (a yardstick the port never calls)
               against the byte bound; then stage 1 on
               one fixed batch for 20 steps, whose last 5 losses must
               average below its first 5
 13. checkpoint - the production stage-2 model from the YAML config
               (load_config + from_cfg), bf16: saved without the T5 trunk,
               in the foreground and the background (ms, MiB), loaded into
               a fresh model (ms; every tensor bit-equal, the live trunk
               kept), served from the file by build_service with the
               DDIM-50 overrides (one micro-batch of TEST.BATCH_SIZE,
               finite motion, 50 kernel launches); then resume: fp32 batch
               4 stage 2, dropout 0.1, 2 steps + save + load + 2 steps
               against 4 straight steps, losses within 1e-6 relative
 14. test_cli - the test CLI (cli/test.main) on real-format inputs: BEAT and
               DnD fixture trees (data/fixture.py) with 32 test items, a
               synthesized 32k t5-geometry spiece.model in the asset drop
               (the model must pick the SentencePiece tokenizer),
               config_cf_beatdnd.yaml with the DDIM-50 overrides, bf16,
               SAVE_PREDICTIONS and 'semantic' WEG, the weights a checkpoint
               of a seeded model: dataset build time, the mel path (native,
               or it fails), loader / tokenize / sample ms per batch,
               exactly 50 kernel launches per batch, the result
               directories and attention-map files, peak memory; then the
               CLI in fp32 at DDIM-4 on one batch of 4 on the card and on
               the CPU (the refinement capped at 3 iterations; phase 6 runs
               the config's): the same files, byte-equal texts and semantic
               CSVs, motion within 1e-3 and latents within 2e-3; then the
               batch mel on the card against the host's
 15. train_cli - the training and rollout CLIs on fixture trees, with a
               synthesized spiece.model in the asset drop: stage 1
               (cli/train.main, config_vae_beatdnd.yaml, bf16, batch 128,
               2 epochs, validation and a background checkpoint each), then
               stage 2 (config_cf_beatdnd.yaml, the stage-1 file
               transplanted, bf16, batch 64, 2 epochs, the T5-trunk and VAE
               posterior caches, prefetch 2): every logged loss finite,
               total/train and total/val in metrics.jsonl, the caches' hits
               and misses (no trunk miss after the first epoch), no host
               wait inside a step (CUDA sync checker), 0 step-kernel
               launches, ms a step and clips/s of the steady epochs beside
               phase 12's Trainer step, the prefetch thread's loader and
               prepare ms a batch and the step loop's wait, peak memory; a
               third epoch through TRAIN.RESUME from epoch=1.ckpt, its
               batches prepared inline (TPU.PREFETCH=0); then
               the stage-2 CLI in fp32, dropout 0, batch 4, 1 epoch on the
               card and on the CPU: each epoch's loss within 1e-4
               relative, every step's gradients within phase 11's
               tolerance, every final weight within 1e-5 + 1e-3 max|w| of
               its tensor or, for at most 100 elements, equal to a float64
               AdamW replay of its device's gradients; then
               cli/unbounded.main from the stage-2 file (bf16, DDIM-50,
               semantic WEG with the refinement capped at 3 iterations, one
               test batch of one-window recordings at MAX_LEN 128, 50
               launches a window, windows/s); eval/run.main over its dump,
               dyadic (the FID forward on the card) and monadic (numpy on
               the host), against --device cpu within 1e-5 relative;
               unguided sample() (guidance scale 1.0), fp32 batch 2,
               DDIM-4 and dpmpp_2m-4, card vs CPU, 0 launches
 16. variants - at the production width: the fused five-stream denoiser
               (weights from the unfused model through the converter), fp32
               batch 4 DDIM-4 on the card against the CPU and against the
               unfused layout (phase 4's bounds), then bf16 batch 96
               DDIM-50 in turns with the unfused layout: clips/s, kernels a
               step, 0 step-kernel launches (JAX's gate); TPU.REMAT: a
               stage-2 fp32 batch-4 step with dropout 0.1 bit-equal to the
               step without it (loss, gradients, generator state), then
               bf16 batch 64 with and without it in turns (ms a step, the
               step's peak memory); vae_type 'no': bf16 batch 96 DDIM-50
               with 50 launches at (7, 96, 128, 189), fp32 batch 4 DDIM-4
               card vs CPU, 3 stage-2 steps with the denoiser's gradient
               finite and nonzero; the learning proof's pipeline
               (train/overfit.run) at 2 + 2 epochs and DDIM-4: every key
               of JAX's result, finite
 17. ablations - every model option the JAX package builds, at the
               production width: sample() fp32 batch 2 DDIM-4 card vs CPU
               (phase 4's bounds, 4 launches a card call) with the
               post-norm, learned-PE, MLP_DIST VAE and the denoiser's
               learned memory PE, and with the all_encoder VAE; the
               trans_enc denoiser, fp32 batch 4, card vs CPU: a stage-2
               loss and its gradients (phase 11's bounds), unguided
               DDIM-4 (0 launches), a guided call that raises;
               EmbedAction (eval, guided), the text condition's emb_proj
               and TextAudioController spk-ta card vs CPU within 1e-5;
               TPU.PALLAS_STEP false against true at bf16 batch 96 DDIM-50
               in turns (ms a call; 50 and 0 launches a call), one fp32
               batch-2 step of both paths within 1e-5 and DDIM-4 within
               phase 4's bounds; the ablated config through cli/train on
               one 7-file tree (stage 1 and stage 2 at batch 14, 2 steps
               each), a save and load of the stage-2 model bit-equal, and
               cli/test on one batch of 32 at DDIM-50 (50 launches)
 18. distributed - the stage-2 train CLI at the YAML batch 64 (one step an
               epoch, 2 epochs) without and with TPU.MULTIHOST under a
               world-size-1 NCCL group (torchrun's environment set
               in-process): losses and weights bit-equal, rank 0's files,
               the barriers passed, no host wait inside a step (CUDA sync
               checker); a SIGTERM after step 1 under the group
               checkpoints, and the resume ends within 1e-6 of the
               straight run; T5 trunk dropout 0.1 through the Trainer
               (stage 2 bf16 batch 64, 3 steps): the trunk bit-identical,
               a second run bit-equal, step 1's loss unlike rate 0's, the
               CLI's trunk cache off, ms a step; the test CLI with a
               charsmap spiece.model on transcripts with non-ASCII
               characters: one batch of 32 at DDIM-50, 50 launches, the
               card's token ids equal to the host tokenizer's, ms to
               tokenize 32 texts with and without the charsmap
 19. tools    - tensor parallelism: one production-geometry stage-2 step,
               fp32 batch 4, dropout 0, through the Trainer with a
               create_mesh(1, 1) mesh and apply_tp under a world-size-1
               NCCL group, against the plain Trainer on the card: step 1's
               loss and every gradient within phase 11's bounds, the losses
               of 3 AdamW steps too, describe_tp's counts, ms a step each
               (one card holds one NCCL rank: the 2- and 4-rank TP steps are
               proven with gloo on the CPU, tests/test_torch_tp*.py); the
               host tools: BEAT-skeleton BVH takes of 7,200 frames (60 s at
               120 fps) through beat_getjoints.convert_speaker on the card
               and on the CPU (joint positions within 1e-4, the float64
               kinematics within 1e-9, ms a file in parse and FK); a
               5-person 120 s session through make_utterance_dataset on the
               card and on the CPU (the same set directories, every file
               byte-equal; sets and ms); the asset manifest: freeze, then
               verify with one file changed and one added, and the CLI's
               exit code 1
Every phase after 3 counts the cross-attention kernel's launches and the
on-card calls that took its plain version, and fails on a bf16 one; and
the LayerNorm kernel's likewise, failing on a bf16 one without grad. Then
each kernel against its plain version at any other shape the path phases
launched it with, the whole run's wall time, a JSON line of per-kernel
numbers (launches summed over phases 5-19 that ran, and each phase's count
under launches_by_phase, every timed shape under shapes; the dpmpp and
training phases launch no step kernel)
and, last, the result line {"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import copy
import dataclasses
import glob
import io
import json
import math
import os
import random
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from convofusion_tpu_torch import native
from convofusion_tpu_torch.cli import test as cli_test
from convofusion_tpu_torch.cli import train as cli_train
from convofusion_tpu_torch.cli import unbounded as cli_unbounded
from convofusion_tpu_torch.cli.unbounded import rollout
from convofusion_tpu_torch.config import (
    DEFAULTS_DIR,
    PRODUCTION,
    PRODUCTION_VAE,
    from_cfg,
    load_config,
    parse_args,
)
from convofusion_tpu_torch.config.omega import OmegaConf
from convofusion_tpu_torch.diffusion.schedulers import DiffusionScheduler
from convofusion_tpu_torch.data import audio
from convofusion_tpu_torch.data.fixture import make_fixture_pair
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_long_batch,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.eval import run as eval_run
from convofusion_tpu_torch.models.convofusion import (
    CachedSampler,
    Convofusion,
    to_tensors,
)
from convofusion_tpu_torch.models import weg as weg_lib
from convofusion_tpu_torch.models.audioenc import TextAudioController
from convofusion_tpu_torch.models.denoiser import Denoiser, EmbedAction
from convofusion_tpu_torch.models.sentencepiece import write_synthetic_spiece
from convofusion_tpu_torch.models.tokenizer import (
    SentencePieceTokenizer,
    focus_word_indices,
)
from convofusion_tpu_torch.ops import adamw
from convofusion_tpu_torch.ops import cross_attend as ca_mod
from convofusion_tpu_torch.ops import guided_step as gs_mod
from convofusion_tpu_torch.ops import layer_norm as ln_mod
from convofusion_tpu_torch.ops import layers, nvcc
from convofusion_tpu_torch.ops.attention import MultiheadAttention
from convofusion_tpu_torch.ops.fused_streams import fuse_denoiser_params
from convofusion_tpu_torch.ops.smoothing import gaussian_kernel_2d
from convofusion_tpu_torch.ops.transformer import COND_STREAMS, REAL_BRANCHES
from convofusion_tpu_torch.parallel import mesh as dist_mesh
from convofusion_tpu_torch.parallel import tp as tp_lib
from convofusion_tpu_torch.scripts import beat_getjoints, synthetic
from convofusion_tpu_torch.scripts import bvh as bvh_lib
from convofusion_tpu_torch.scripts.make_utterance_dataset import (
    process_session,
)
from convofusion_tpu_torch.scripts.transcribe import NullTranscriber
from convofusion_tpu_torch.serving import (
    GestureRequest,
    build_service,
    serve_http,
)
from convofusion_tpu_torch.train import checkpoint as ckpt_lib
from convofusion_tpu_torch.utils import assets as assets_lib
from convofusion_tpu_torch.utils import cuda_graphs
from convofusion_tpu_torch.utils.profiling import COUNTS
from convofusion_tpu_torch.train import overfit
from convofusion_tpu_torch.train.trainer import (
    Trainer,
    make_optimizer,
    trainable_parameters,
)

# bench.py:26-29 (batch, steps); timed calls of phases 5 and 10 (cut
# from 3 to keep the whole run in its time)
BATCH, STEPS, TIMED_CALLS = 96, 50, 2
# phase 5: the batches at which graphed sampling is held to eager (the
# sampling cell's 32 and the main path's 96)
GRAPH_BATCHES = (32, BATCH)
KERNEL_TOL = 1e-5
TIMING_RUNS = 200
PROFILE_STEPS = 5
# the step kernel's (elements a block, threads a block) at the main path's
# case: 192, 128 and 96 blocks at B = 96 on the card's 132 SMs
SWEEP = [(tile, threads) for tile in (1024, 1536, 2048)
         for threads in (128, 256)]
# the other batches the path phases give the kernel (B * 16 * 128 elements;
# 20 and 16 end on a short block at the tile of 1536): 2 in phases 6 and 8,
# 4 in 14's parity run, 32 in 13 and 14, 8-16 in 15's rollout, 20 for a
# fixture of 4 BEAT files.  main() holds the kernel at any other shape a
# path phase launched it with as well
PATH_BATCHES = (2, 4, 8, 16, 20, 32)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# fp32 (non-tensor-core) flop/s
PEAK_BYTES_PER_S = 3.35e12
# the guided cross-attention kernel (phase 3): each stream's Tk at the
# published geometry (text 64, mel frames 161, apb 8, listener id 1); the
# two text streams carry padding masks; cases (B, Tq, uncond K/V batch)
CROSS_TK = {"spkemb": 64, "alsn": 161, "tlsn": 64, "apb": 8, "lsnemb": 1}
CROSS_MASKED = ("spkemb", "tlsn")
CROSS_CASES = {"published": (32, 16, 1), "b1": (1, 16, 1),
               "b96": (BATCH, 16, 1), "raw_motion_tq128": (32, 128, 1),
               "uncond_batch_b": (32, 16, 32)}
CROSS_RTOL = 1e-2     # relative RMS, on the output and on the weights
# the guided LayerNorm kernel (phase 3): the batches whose guided calls it
# is held at (the sampling cell's 32, the main path's 96, the service's
# 20, a batch of 1), Tq 16 and, for raw motion, 128; each stream's memory
# rows (Tk, stored dtype); PyTorch's LayerNorm sums in an order the kernel
# repeats, but its build may contract another multiply-add than the
# kernel's __fmaf_rn: at most LN_MAX_ULPS bf16 ulp on at most
# LN_MAX_DIFFER of the elements
LN_BATCHES = ((32, 16), (BATCH, 16), (20, 16), (1, 16), (32, 128))
LN_STREAMS = {"spkemb": (64, "bfloat16"), "alsn": (161, "bfloat16"),
              "tlsn": (64, "bfloat16"), "apb": (8, "float32"),
              "lsnemb": (1, "float32")}
LN_MAX_ULPS, LN_MAX_DIFFER = 1, 1e-3
PEAK_FP32_FLOPS = 67e12
# guided_step per element: 8 for the guidance combine, 5 for x0 and its
# clip, 6-7 for the DDPM or DDIM update
STEP_FLOPS_PER_ELEMENT = 20
# card-vs-CPU fp32 motion after PARITY_STEPS guided steps (cut from 50):
# see phase_parity
PARITY_STEPS, PARITY_ATOL = 20, 1e-3
# phase 6: DDIM-5 with WEG (cut from 10); the tolerance is argued in
# phase_weg_parity
WEG_STEPS = 5
WEG_PARITY_ATOL = 1e-3
WEG_LATENT_ATOL = 2e-3
# the refinement forced at step 0: the loop runs to its bound on both sides
WEG_FORCED = {"thresholds": {0: 0.99}, "max_refinement_steps": 5}
# timed calls of one WEG step in each form (cut from 20)
WEG_COST_CALLS = 10
# phase 7: client threads, timed micro-batches (cut from 2) and the
# HTTP requests
SERVE_CLIENTS, SERVE_TIMED_BATCHES, SERVE_HTTP_REQUESTS = 8, 1, 4
# every Nth service request carries no focus words
NO_FOCUS_EVERY = 5
# phase 8: DDIM-4 rollouts (cut from 10) of 2 parts (3 windows);
# tolerances argued in phase_rollout_parity
ROLLOUT_PARITY_STEPS, ROLLOUT_PARITY_PARTS = 4, 2
ROLLOUT_MOTION_ATOL, ROLLOUT_LATENT_ATOL = 1e-3, 2e-3
# phase 9: parts of a rollout (bench.py --mode rollout's 3, cut to 2; 2
# parts are 3 windows) and timed rollouts (batch and steps as phase 5);
# the warm-up and the WEG rollout take one part (one window; cut from 2)
ROLLOUT_PARTS, ROLLOUT_TIMED, ROLLOUT_SHORT_PARTS = 2, 1, 1
# phase 10: DPM-Solver++ 2M steps (bench.py --sampler dpmpp_2m --steps 20)
DPMPP_STEPS = 20
DPMPP_ATOL, DPMPP_LATENT_ATOL = 1e-3, 2e-3
# phase 11: training card vs CPU, fp32; tolerances argued in
# phase_train_parity
TRAIN_PARITY_BATCH, TRAIN_PARITY_STEPS = 4, 3
TRAIN_LOSS_RTOL, TRAIN_FIT_RTOL = 1e-4, 1e-3
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3
# phase 12: the production batch sizes (config_cf_beatdnd.yaml:11,
# config_vae_beatdnd.yaml:17), warm-up, timed (cut from 20, then 10) and
# profiled steps, and the stage-1 learning check's steps (cut from 50)
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED, LEARN_STEPS = 3, 6, 2, 20
# phase 12: graphed steps held bit-equal to as many eager ones
TRAIN_COMPARED = 3
TRAIN_GRAPH_COUNTERS = ("train.graph_captures", "train.graph_replays",
                        "train.graph_eager", "adamw.launches")
# phase 12: the AdamW kernel against the plain chain: steps, each step's
# gradient scale (the clip at ADAMW_CLIP keeps some steps and scales
# others), every ADAMW_ABSENT_EVERY-th gradient absent; gaps allowed where
# the clip's norm is the kernel's own (the pre-pass sums in another order);
# launches timed back to back, and the chunk sizes swept
ADAMW_STEPS, ADAMW_SCALES, ADAMW_CLIP = 4, (1e-3, 1e-4, 1e-2, 1e-3), 1.0
ADAMW_ABSENT_EVERY = 7
ADAMW_FP32_ULPS, ADAMW_BF16_ULPS = 4, 1
ADAMW_TIMED = 20
ADAMW_CHUNKS = (2048, 4096, 8192, 16384, 32768)
TRAIN_DIFFUSION_BATCH = PRODUCTION["train"]["batch_size"]
TRAIN_VAE_BATCH = PRODUCTION_VAE["train"]["batch_size"]
# phase 13: the YAML scheduler is DDPM-1000 (modules/scheduler.yaml:1-11);
# the served batch takes bench.py's DDIM-50 through dotlist overrides
DDIM_OVERRIDES = ["model.scheduler.variant=ddim",
                  f"model.scheduler.num_inference_timesteps={STEPS}"]
# the resume check: batch, (N, M) steps, and the loss tolerance argued in
# resume_check
CKPT_RESUME_BATCH, CKPT_RESUME_STEPS, CKPT_RESUME_RTOL = 4, (2, 2), 1e-6
# phase 14: the test CLI on fixture trees; 2 BEAT speakers x 7 files x 2
# chunks and 4 DnD items make one full TEST.BATCH_SIZE batch of 32
# (config_cf_beatdnd.yaml:36; the second batch of 8 files is cut);
# the card-vs-CPU run is fp32 DDIM-4 (cut from 10) on one batch of 4 BEAT
# items (phases 6, 8 and 10's tolerances); the batch mel against the
# host's within 1e-4 of the largest power and 1e-2 dB
CLI_BEAT_FILES, CLI_PARITY_BATCH, CLI_PARITY_STEPS = 7, 4, 4
# the parity run's WEG refinement bound: the config's 300 iterations take
# ~55 s on 8 CPU cores at this width; phase 6 holds the full loop
CLI_PARITY_REFINE = 3
CLI_MOTION_ATOL, CLI_LATENT_ATOL = 1e-3, 2e-3
MEL_POWER_RTOL, MEL_DB_ATOL = 1e-4, 1e-2
# phase 15: the training and rollout CLIs, eval and unguided sampling.  2
# BEAT speakers x 64 files of 11 s (2 chunks each) + the DnD listener
# items fill stage 1's batch of 128 twice and stage 2's of 64 four times;
# 2 epochs a stage (cut from 3), then a resumed third for stage 2
TRAIN_CLI_FILES, TRAIN_CLI_EPOCHS = 64, 2
# card vs CPU through the CLI: fp32, dropout 0, batch 4, 1 stage-2 epoch
# (cut from 2) on a 1-file fixture (2 steps an epoch); tolerances argued in
# train_cli_parity
TRAIN_CLI_PARITY_BATCH, TRAIN_CLI_PARITY_EPOCHS = 4, 1
TRAIN_CLI_LOSS_RTOL = 1e-4
TRAIN_CLI_WEIGHT_ATOL, TRAIN_CLI_WEIGHT_RTOL = 1e-5, 1e-3
# an element beyond that bound must be what AdamW makes of the recorded
# gradients: its final weight within 1e-6 of a float64 AdamW replay on
# each side; at most this many such elements
TRAIN_CLI_REPLAY_ATOL, TRAIN_CLI_REPLAY_MAX = 1e-6, 100
# the rollout CLI at MAX_LEN 128 (one window; cut from 256 and 3 windows:
# phases 8 and 9 run the preseq inpainting of later windows) on one test
# batch of 2 speakers x 4 files + the DnD items, the refinement loop of the
# rollout's fixed WEG parameters
# (cli/unbounded.ROLLOUT_WEG_PARAMETERS, as the reference's) capped at 3
# iterations a refined step: at its bound of 300 the random weights never
# meet the threshold and a window took 28-40 s; phase 6 runs a forced loop
# to its bound
UNBOUNDED_FILES, UNBOUNDED_MAX_LEN, UNBOUNDED_REFINE = 4, 128, 3
# eval/run on the card against --device cpu
EVAL_RTOL = 1e-5
# unguided sampling (guidance_scale 1.0), card vs CPU, fp32 batch 2,
# 4 steps (cut from 10)
UNGUIDED_STEPS = 4
# phase 16: the fused layout, REMAT and raw motion at the production
# width: card-vs-CPU runs at fp32 batch 4 DDIM-4 (cut from 10; phase 4's
# motion bound; the latents' as phases 6, 8 and 10), timed runs in turns
# after a warm-up (1 turn and 1 warm-up step, cut from 2 each); the
# learning proof's pipeline at 2 + 2 epochs (cut from 20 + 20: every key
# of JAX's result, as tests/test_torch_overfit_run.py on the CPU)
VARIANT_PARITY_BATCH, VARIANT_PARITY_STEPS = 4, 4
VARIANT_LATENT_ATOL = 2e-3
VARIANT_WARMUP, VARIANT_TURNS = 1, 1
# the warm-up call before timed turns (phases 16, 17): DDIM-2, not -50
# (the first call's one-time costs come within its first step)
WARMUP_STEPS = 2
OVERFIT_EPOCHS = 2
# the raw-motion (vae_type 'no') latents the step kernel takes: (B, 128,
# 189) at phase 16's batches
RAW_MOTION_BATCHES = (VARIANT_PARITY_BATCH, BATCH)
# phase 17: the ablations at the production width.  sample() card vs CPU
# at fp32 batch 2 DDIM-4 (cut from 10; phase 4's motion bound, the
# latents' of phases 6, 8 and 10; exactly 4 launches a card call); trans_enc
# at fp32 batch 4 (phase 11's loss and gradient bounds, then unguided
# DDIM-4 at phase 4's);
# the modules card vs CPU within 1e-5; TPU.PALLAS_STEP false against true
# at bf16 batch 96 DDIM-50 in turns after a warm-up each, and one fp32
# batch-2 step of both paths within 1e-5
ABLATION_PARITY_BATCH, ABLATION_STEPS, TRANS_ENC_BATCH = 2, 4, 4
ABLATION_MODULE_ATOL, STEP_PATHS_ATOL = 1e-5, 1e-5
STEP_PATH_TURNS = 1          # cut from 2
# the CLIs with the post-norm, learned-PE, MLP_DIST VAE (and the denoiser's
# learned memory PE) on one 7-file tree (phase 14's): stage 1's and stage
# 2's 2 steps at batch 14 (29 train items), the test CLI's one batch of 32
# without its result files.  Cut from 2 steps of 128 and of 64 on 64- and
# 32-file trees: phase 15 runs the same CLI code at the YAML batches
ABLATION_CLI_FILES, ABLATION_CLI_BATCH = CLI_BEAT_FILES, 14
ABLATION_OVERRIDES = ["model.motion_vae.params.normalize_before=false",
                      "model.motion_vae.params.position_embedding=learned",
                      "TRAIN.ABLATION.MLP_DIST=true",
                      "model.denoiser.params.position_embedding=learned"]
# phase 18: the stage-2 train CLI at the YAML batch of 64 on a 16-file tree
# (74 train items: one step an epoch), 2 epochs, without and with a
# world-size-1 NCCL group; a SIGTERM after step 1, then the resume, within
# 1e-6 of the straight run's weights.  T5 trunk dropout 0.1 through the
# Trainer, stage 2 bf16 batch 64, 3 steps.  The test CLI with a charsmap
# spiece.model on phase 14's tree, its transcripts drawn from words with
# curly quotes, accents, NBSP, a ligature, full-width letters and a
# decomposed accent among plain ones
DISTRIBUTED_FILES, DISTRIBUTED_EPOCHS, DISTRIBUTED_RESUME_ATOL = 16, 2, 1e-6
T5_DROPOUT, T5_DROPOUT_STEPS = 0.1, 3
# phase 19: BEAT takes of 60 s at 120 fps, a 120 s 5-person DnD session
BVH_FILES, BVH_FRAMES, BVH_ATOL, FK_ATOL = 3, 7200, 1e-4, 1e-9
SESSION_SECONDS = 120
CHARSMAP_WORDS = ("hello", "there", "friend", "story", "brave", "knights",
                  "dragons", "dice", "laugh", "night", "it\u2019s",
                  "\u201cfine\u201d", "caf\u00e9", "na\u00efve",
                  "good\u00a0night", "\ufb01re", "\uff27\uff4f",
                  "cafe\u0301", "\u2018yes\u2019", "r\u00e9sum\u00e9")
# what earlier phases of this run measured, for later phases to print
PHASE_RESULTS = {}


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
    kernels = (("guided_step.cu", gs_mod), ("adamw.cu", adamw),
               ("cross_attend.cu", ca_mod), ("layer_norm.cu", ln_mod))
    t_all = time.perf_counter()
    # the compiles run side by side, one process each
    for _, mod in kernels:
        nvcc.start(mod.SOURCE, mod.LIBRARY)
    for name, mod in kernels:
        t0 = time.perf_counter()
        report = mod.build()
        log(f"# build: {name} done {time.perf_counter() - t0:.2f} s later")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {line.strip()}")
    log(f"# build: all in {time.perf_counter() - t_all:.2f} s")


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


def step_inputs(dtype=torch.bfloat16, batch=BATCH, shape=None):
    """Seeded (7, B, 16, 128) branch planes (or (7,) + ``shape``), latents
    and noise on the card, and the three step cases (alpha_t, alpha_prev,
    is_ddpm, add_noise)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = shape or (batch, 16, PRODUCTION["latent_dim"][1])
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


def kernel_at_shapes(shapes):
    """The kernel against its plain version in the three step cases at
    each (latents shape, plane dtype) of ``shapes``; the largest gap."""
    max_err = 0.0
    for shape, dtype in sorted(shapes, key=str):
        np7, lat, noise, cases = step_inputs(dtype, shape=shape)
        for scalars in cases.values():
            max_err = max(max_err, kernel_error((np7, lat, noise) + scalars))
    return max_err


def phase_kernel():
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    rows, max_err = {}, 0.0
    dtypes = (torch.float32, torch.bfloat16)
    latent = (16, PRODUCTION["latent_dim"][1])
    raw = (128, PRODUCTION["nfeats"])        # vae_type 'no': raw motion
    timed = {(BATCH,) + latent, (BATCH,) + raw}
    checked = {((b,) + latent, dtype) for b in PATH_BATCHES + (BATCH,)
               for dtype in dtypes}
    checked |= {((b,) + raw, dtype) for b in RAW_MOTION_BATCHES
                for dtype in dtypes}
    err = kernel_at_shapes({(s, d) for s, d in checked if s not in timed})
    max_err = max(max_err, err)
    log(f"# kernel guided_step at batches {list(PATH_BATCHES)} of "
        f"(B, 16, 128) and {list(RAW_MOTION_BATCHES[:-1])} of (B, 128, 189),"
        f" fp32 and bf16 planes, the three cases: max|diff| {err:.3g} (tol "
        f"{KERNEL_TOL})")
    for shape, dtype in sorted(((s, d) for s in timed for d in dtypes),
                               key=str):
        np7, lat, noise, cases = step_inputs(dtype, shape=shape)
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
            key = (f"{name}/{str(dtype).split('.')[-1]}"
                   f"{'/raw' if shape[1:] == raw else ''}")
            rows[key] = dict(shape=[7, *shape], max_abs_err=err, ms=ms,
                             warm_ms=warm_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by)
            log(f"# kernel guided_step {key}: max|diff| {err:.3g}  kernel "
                f"{ms * 1e3:.2f} us (back to back, L2 warm {warm_ms * 1e3:.2f} "
                f"us)  plain "
                f"{plain_ms * 1e3:.2f} us  bound {bound * 1e3:.2f} us "
                f"({bound_by})")

    # the sweep, at the main path's case: bf16 planes, DDIM
    np7, lat, noise, cases = step_inputs(torch.bfloat16)
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
    return rows, max_err, checked


def cross_geometry(case, stream):
    """A CROSS_CASES case's ``ca_mod.geometry`` for one stream: the
    stream's published Tk for both variants; the text streams masked."""
    b, tq, unc_batch = CROSS_CASES[case]
    tk, masked = CROSS_TK[stream], stream in CROSS_MASKED
    return (b, tq, tk, tk, unc_batch, b if masked else 0,
            unc_batch if masked else 0, REAL_BRANCHES[stream])


def cross_inputs(geom, seed):
    """Seeded bf16 q_all (7, B, Tq, 512), each variant's K/V as the halves
    of one (B or uncond batch, Tk, 1024) projection, and each variant's
    padding mask (its batch from ``geom``; 0: None) with every key of row
    0 padded, for a ``ca_mod.geometry`` ``geom``."""
    b, tq, tk_r, tk_u, unc_batch, m_r, m_u, _ = geom
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = PRODUCTION["denoiser"]["text_encoded_dim"]

    def randn(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    def mask(rows, tk):
        if not rows:
            return None
        m = torch.rand(rows, tk, generator=gen, device="cuda") < 0.3
        m[0] = True
        return m

    q = randn(7, b, tq, d)
    kv_r = randn(b, tk_r, 2 * d).chunk(2, dim=-1)
    kv_u = randn(unc_batch, tk_u, 2 * d).chunk(2, dim=-1)
    return q, kv_r, kv_u, (mask(m_r, tk_r), mask(m_u, tk_u))


def cross_bytes(q, kv_r, kv_u, masks):
    """Bytes the core must move: q_all read and out written, both
    variants' K/V and masks read, the weights (B, Tq, Tk) written."""
    _, b, tq, _ = q.shape
    n = 2 * q.numel() * q.element_size()
    n += sum(t.numel() * t.element_size() for t in kv_r + kv_u)
    n += sum(m.numel() for m in masks if m is not None)
    return n + b * tq * kv_r[0].shape[1] * q.element_size()


def _ordered(t):
    """bf16 bit patterns as integers in the order of the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i + 32768), i)


def cross_exact(q, kv_r, kv_u, masks, real):
    """The core in fp64 with the plain version's bf16 rounding points (q
    k^T, its scaling, P and P v each computed exactly and rounded once to
    bf16; the softmax exact): out (G, B, Tq, D) and the last real
    branch's weights, bf16.  A witness for the kernel and the plain
    version alike: each departs from it by its own accumulation order."""
    def bf(t):
        return t.to(torch.bfloat16).double()

    inv = ca_mod._inv_scale(q.shape[-1])
    neg = float(torch.tensor(-1e9, dtype=torch.bfloat16))
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for rows, (k, v), m in ((real, kv_r, masks[0]),
                            (ca_mod.unc_branches(real, q.shape[0]), kv_u,
                             masks[1])):
        idx = torch.tensor(rows, device=q.device)
        s = bf(q.index_select(0, idx).double()
               @ k.double().transpose(-1, -2))
        s = bf(s * inv)
        if m is not None:
            s = s.masked_fill(m[None, :, None, :], neg)
        p = bf(torch.softmax(s, dim=-1))
        out[idx] = bf(p @ v.double())
        if rows == tuple(real):
            att = p[-1]
    return out.to(torch.bfloat16), att.to(torch.bfloat16)


def cross_gap(got, want):
    """How far ``got`` is from ``want`` (bf16): relative RMS, the share of
    elements that differ, and the largest gap in bf16 ulps over the
    elements at least a tenth of ``want``'s RMS from zero (near zero a
    one-ulp step of the products crosses many ulps of the result)."""
    g, w = got.float(), want.float()
    rms = w.norm() / w.numel() ** 0.5
    away = w.abs() >= 0.1 * rms
    ulps = (_ordered(got) - _ordered(want)).abs()
    return dict(rel=float((g - w).norm() / w.norm()),
                differ=float((got != want).float().mean()),
                ulps=int(ulps[away].max()) if bool(away.any()) else 0)


def cross_check(mod, geom, seed):
    """The kernel (through ``grouped_cross_attend``, as ``guided`` calls
    it) against the plain version at ``geom``, both against
    :func:`cross_exact`: the gaps of the output and of the weights.
    Raises where the kernel's relative RMS from the plain version passes
    CROSS_RTOL."""
    q, kv_r, kv_u, masks = cross_inputs(geom, seed)
    real = geom[-1]
    idx = [torch.tensor(t, device="cuda") for t in
           (real, ca_mod.unc_branches(real, 7))]
    with torch.no_grad():
        got = ca_mod.grouped_cross_attend(mod, q, kv_r, kv_u, *masks, real,
                                          *idx)
        want = ca_mod.cross_attend_reference(mod, q, kv_r, kv_u, *masks,
                                             *idx)
        exact = cross_exact(q, kv_r, kv_u, masks, real)
    torch.cuda.synchronize()
    gaps = {}
    for i, what in enumerate(("out", "weights")):
        gaps[what] = dict(plain=cross_gap(got[i], want[i]),
                          exact=cross_gap(got[i], exact[i]),
                          plain_exact=cross_gap(want[i], exact[i]))
        rel = gaps[what]["plain"]["rel"]
        if not rel <= CROSS_RTOL:
            raise RuntimeError(f"cross_attend {geom} {what}: relative RMS "
                               f"{rel} > {CROSS_RTOL}")
    return gaps


def _worst(worst, gaps):
    for what, by in gaps.items():
        for against, gap in by.items():
            row = worst.setdefault(f"{what}/{against}",
                                   dict(rel=0.0, differ=0.0, ulps=0))
            for k, v in gap.items():
                row[k] = max(row[k], v)


def cross_line(gaps):
    return "; ".join(
        f"{what} against {against.replace('_', ' ')}: rel RMS "
        f"{g['rel']:.3g}, {g['differ']:.2%} differ, {g['ulps']} ulps away "
        f"from 0" for what, by in gaps.items() for against, g in by.items())


def phase_cross_attend(flush):
    """The guided cross-attention kernel, through ``grouped_cross_attend``,
    against its plain version on the card in every case of CROSS_CASES
    and every stream (relative RMS of the output and of the weights at
    most CROSS_RTOL), both against the fp64 witness ``cross_exact``; a
    CUDA graph's replay bit-equal to the eager call; at the published
    geometry CUDA-event times of the kernel's graph replay (L2 flushed, and
    back to back) and of the plain version's against the byte bound, per
    stream and summed over a layer's five.  Returns the results and the geometries held."""
    mod = MultiheadAttention(PRODUCTION["denoiser"]["text_encoded_dim"], 1,
                             torch.bfloat16).cuda()
    worst, timed, checked = {}, {}, set()
    for case in CROSS_CASES:
        for s in COND_STREAMS:
            geom = cross_geometry(case, s)
            checked.add(geom)
            gaps = cross_check(mod, geom, 31 + CROSS_TK[s])
            _worst(worst, gaps)
            log(f"# kernel cross_attend {case} {s}: {cross_line(gaps)}")
            if case != "published":
                continue
            q, kv_r, kv_u, masks = cross_inputs(geom, 31 + CROSS_TK[s])
            real = geom[-1]
            idx = [torch.tensor(t, device="cuda") for t in
                   (real, ca_mod.unc_branches(real, 7))]
            # each replayed from a CUDA graph, as the guided graph runs
            # them: the wrapper's host work (tens of us) would otherwise
            # outlast the flush and enter the bracket
            pool = cuda_graphs.GraphPool()
            with torch.no_grad():
                kernel, _ = pool.capture(
                    lambda: ca_mod.cross_attend(q, kv_r, kv_u, *masks, real),
                    q.device)
                plain, _ = pool.capture(
                    lambda: ca_mod.cross_attend_reference(
                        mod, q, kv_r, kv_u, *masks, *idx), q.device)
            ms = _event_median_ms(kernel.replay, flush)
            warm_ms = _back_to_back_ms(kernel.replay)
            plain_ms = _event_median_ms(plain.replay, flush)
            bound = cross_bytes(q, kv_r, kv_u, masks) / PEAK_BYTES_PER_S * 1e3
            timed[s] = dict(tk=CROSS_TK[s], ms=ms, warm_ms=warm_ms,
                            plain_ms=plain_ms, bound_ms=bound)
            log(f"# kernel cross_attend {s} (7, 32, 16, 512) Tk "
                f"{CROSS_TK[s]}: kernel {ms * 1e3:.2f} us (back to back "
                f"{warm_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, "
                f"bound {bound * 1e3:.2f} us (bytes)")
    layer = {k: sum(r[k] for r in timed.values())
             for k in ("ms", "warm_ms", "plain_ms", "bound_ms")}
    log(f"# kernel cross_attend: a layer's five streams at (7, 32, 16, 512):"
        f" kernel {layer['ms'] * 1e3:.2f} us (back to back "
        f"{layer['warm_ms'] * 1e3:.2f} us; "
        f"{layer['bound_ms'] / layer['ms']:.1%} of the byte bound "
        f"{layer['bound_ms'] * 1e3:.2f} us), plain "
        f"{layer['plain_ms'] * 1e3:.2f} us; over {sorted(CROSS_CASES)} x 5 "
        f"streams, the worst (tol {CROSS_RTOL} on the relative RMS against "
        f"the plain version): "
        + "; ".join(f"{k}: rel RMS {v['rel']:.3g}, {v['differ']:.2%} differ,"
                    f" {v['ulps']} ulps away from 0"
                    for k, v in sorted(worst.items())))
    # a graph's replay against the eager call, on new inputs
    geom = cross_geometry("published", "alsn")
    q, kv_r, kv_u, masks = cross_inputs(geom, 41)
    static = (q.clone(), tuple(t.clone() for t in kv_r))
    real = geom[-1]
    with torch.no_grad():
        graph, outs = cuda_graphs.GraphPool().capture(
            lambda: ca_mod.cross_attend(static[0], static[1], kv_u, *masks,
                                        real), torch.device("cuda"))
        q2, kv2, _, _ = cross_inputs(geom, 42)
        static[0].copy_(q2)
        for dst, src in zip(static[1], kv2):
            dst.copy_(src)
        graph.replay()
        eager = ca_mod.cross_attend(q2, kv2, kv_u, *masks, real)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs, eager)):
        raise RuntimeError("cross_attend: a graph replay differs from the "
                           "eager call")
    log("# kernel cross_attend: a CUDA graph's replay on new inputs "
        "bit-equal to the eager call")
    return dict(layer=layer, streams=timed, worst=worst), checked


def ln_geometries(b, tq):
    """The ``ln_mod.geometry`` of each LayerNorm of a guided call at batch
    ``b`` and Tq ``tq`` with batch-1 uncond rows: norm1-3 and the final
    norm, the TimeBlocks' (with the epilogue), each stream's memory norm
    of both variants."""
    rows, d = 7 * b * tq, PRODUCTION["denoiser"]["text_encoded_dim"]
    geoms = {(rows, d, "float32", None), (rows, d, "float32", (tq, b))}
    for tk, dtype in LN_STREAMS.values():
        geoms |= {(b * tk, d, dtype, None), (tk, d, dtype, None)}
    return geoms


def ln_inputs(geom, seed, unit=False):
    """Seeded inputs of a geometry: x (rows, D) in its dtype, or (G, B,
    T, D) with the epilogue's bf16 scale and shift (1, B, 1, D) as the
    halves of one projection; a LayerNorm whose weight and bias are one and
    zero (``unit``, as the model's init) or drawn."""
    rows, d, dtype, mod = geom
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    norm = layers.LayerNorm(d).cuda()
    if not unit:
        with torch.no_grad():
            norm.weight.copy_(1 + 0.1 * randn(d))
            norm.bias.copy_(0.1 * randn(d))
    scale = shift = None
    shape = (rows, d)
    if mod is not None:
        tq, b = mod
        shape = (rows // (tq * b), b, tq, d)
        scale, shift = (0.5 * randn(1, b, 1, 2 * d)).to(
            torch.bfloat16).chunk(2, dim=-1)
    x = (2 * randn(*shape) + 0.3).to(getattr(torch, dtype))
    return x, norm, scale, shift


def ln_gap(got, want):
    """bf16 ulps between got and want: the largest, and the share of
    elements that differ."""
    ulps = (_ordered(got) - _ordered(want)).abs()
    return dict(ulps=int(ulps.max()),
                differ=float((got != want).float().mean()))


def ln_check(geom, seed):
    """The kernel, through ``normalize`` as ``guided`` calls it, against the
    plain version at ``geom``, with drawn and with unit weights; raises
    past LN_MAX_ULPS or LN_MAX_DIFFER.  The worst gap."""
    consumer = layers.Linear(8, 8, dtype=torch.bfloat16).cuda()
    worst = dict(ulps=0, differ=0.0)
    for unit in (False, True):
        x, norm, scale, shift = ln_inputs(geom, seed, unit)
        launches = COUNTS["layer_norm.launches"]
        with torch.no_grad():
            got = ln_mod.normalize(norm, x, consumer, scale, shift)
            want = ln_mod.layer_norm_reference(x, norm, torch.bfloat16,
                                               scale, shift)
        torch.cuda.synchronize()
        if COUNTS["layer_norm.launches"] != launches + 1:
            raise RuntimeError(f"layer_norm {geom}: the kernel was not "
                               f"launched")
        gap = ln_gap(got, want)
        if gap["ulps"] > LN_MAX_ULPS or gap["differ"] > LN_MAX_DIFFER:
            raise RuntimeError(f"layer_norm {geom} unit={unit}: {gap} past "
                               f"{LN_MAX_ULPS} ulps on {LN_MAX_DIFFER:.1%}")
        worst = {k: max(worst[k], gap[k]) for k in worst}
    return worst


def ln_bytes(x, scale):
    """Bytes a norm must move: x read in its dtype and the bf16 output
    written, the weight and bias, the scale and shift rows."""
    n = x.numel() * (x.element_size() + 2) + 2 * 4 * x.shape[-1]
    if scale is not None:
        n += 2 * scale.numel() * 2
    return n


def phase_layer_norm(flush):
    """The guided LayerNorm kernel, through ``normalize``, against its plain
    version at every geometry of LN_BATCHES' guided calls (ln_check); at
    the sampling cell's batch 32 CUDA-event times, each replayed from a
    CUDA graph, of the kernel (L2 flushed, and back to back), the plain
    version and ``F.layer_norm`` + the bf16 cast (in the input's dtype:
    the library's yardstick, without the epilogue) against the byte
    bound, per norm and over a layer's 15; the first layer's expanded
    branches; a graph's replay bit-equal to the eager call.  Returns the
    results and the geometries held."""
    checked, worst = set(), dict(ulps=0, differ=0.0)
    for i, (b, tq) in enumerate(LN_BATCHES):
        for j, geom in enumerate(sorted(ln_geometries(b, tq), key=str)):
            gap = ln_check(geom, 61 + 20 * i + j)
            checked.add(geom)
            worst = {k: max(worst[k], gap[k]) for k in worst}
    # the first layer's norm1 reads the branches as one expanded tensor
    d = PRODUCTION["denoiser"]["text_encoded_dim"]
    x, norm, _, _ = ln_inputs((32 * 16, d, "float32", None), 60)
    x = x.reshape(1, 32, 16, -1).expand(7, 32, 16, -1)
    with torch.no_grad():
        gap = ln_gap(ln_mod.layer_norm(x, norm),
                     ln_mod.layer_norm_reference(x, norm, torch.bfloat16))
    if gap["ulps"] > LN_MAX_ULPS or gap["differ"] > LN_MAX_DIFFER:
        raise RuntimeError(f"layer_norm over expanded branches: {gap}")
    worst = {k: max(worst[k], gap[k]) for k in worst}
    log(f"# kernel layer_norm: {len(checked)} geometries of the guided calls"
        f" at (B, Tq) {list(LN_BATCHES)}, drawn and unit weights: at most "
        f"{worst['ulps']} bf16 ulps, {worst['differ']:.4%} of elements differ"
        f" (limits {LN_MAX_ULPS} ulp, {LN_MAX_DIFFER:.1%})")
    # a layer's 15 norms at the sampling cell's batch: norm1-3, the two
    # TimeBlocks, the memory norms of both variants
    rows = 7 * 32 * 16
    layer = [(rows, d, "float32", None)] * 3 + \
        [(rows, d, "float32", (16, 32))] * 2
    for tk, dtype in LN_STREAMS.values():
        layer += [(32 * tk, d, dtype, None), (tk, d, dtype, None)]
    pool = cuda_graphs.GraphPool()
    timed, sums = [], dict(ms=0.0, warm_ms=0.0, plain_ms=0.0,
                           library_ms=0.0, bound_ms=0.0)
    with torch.no_grad():
        for geom in sorted(set(layer), key=str):
            x, norm, scale, shift = ln_inputs(geom, 7)
            w, bias = norm.weight.to(x.dtype), norm.bias.to(x.dtype)
            kernel, _ = pool.capture(
                lambda: ln_mod.layer_norm(x, norm, scale, shift), x.device)
            plain, _ = pool.capture(
                lambda: ln_mod.layer_norm_reference(
                    x, norm, torch.bfloat16, scale, shift), x.device)
            library, _ = pool.capture(
                lambda: F.layer_norm(x, (x.shape[-1],), w, bias,
                                     norm.eps).to(torch.bfloat16), x.device)
            row = dict(geometry=list(geom[:3]) + [geom[3] and list(geom[3])],
                       ms=_event_median_ms(kernel.replay, flush),
                       warm_ms=_back_to_back_ms(kernel.replay),
                       plain_ms=_event_median_ms(plain.replay, flush),
                       library_ms=_event_median_ms(library.replay, flush),
                       bound_ms=ln_bytes(x, scale) / PEAK_BYTES_PER_S * 1e3)
            n = layer.count(geom)
            for k in sums:
                sums[k] += n * row[k]
            timed.append(row)
            log(f"# kernel layer_norm {geom} (x{n} a layer): kernel "
                f"{row['ms'] * 1e3:.2f} us (back to back "
                f"{row['warm_ms'] * 1e3:.2f} us), plain "
                f"{row['plain_ms'] * 1e3:.2f} us, F.layer_norm + cast "
                f"{row['library_ms'] * 1e3:.2f} us, bound "
                f"{row['bound_ms'] * 1e3:.2f} us (bytes)")
    share = {k: sums["bound_ms"] / sums[k] for k in ("ms", "warm_ms")}
    log(f"# kernel layer_norm: a layer's 15 norms at batch 32: kernel "
        f"{sums['ms'] * 1e3:.2f} us L2 flushed ({share['ms']:.1%} of the "
        f"byte bound {sums['bound_ms'] * 1e3:.2f} us), back to back "
        f"{sums['warm_ms'] * 1e3:.2f} us ({share['warm_ms']:.1%}), plain "
        f"{sums['plain_ms'] * 1e3:.2f} us, F.layer_norm + cast "
        f"{sums['library_ms'] * 1e3:.2f} us")
    # a graph's replay on new inputs against the eager call
    geom = (rows, d, "float32", (16, 32))
    x, norm, scale, shift = ln_inputs(geom, 8)
    static = x.clone()
    with torch.no_grad():
        graph, out = pool.capture(
            lambda: ln_mod.layer_norm(static, norm, scale, shift), x.device)
        static.copy_(ln_inputs(geom, 9)[0])
        graph.replay()
        eager = ln_mod.layer_norm(static, norm, scale, shift)
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise RuntimeError("layer_norm: a graph replay differs from the "
                           "eager call")
    log("# kernel layer_norm: a CUDA graph's replay on new inputs bit-equal "
        "to the eager call")
    return dict(layer=sums, norms=timed, worst=worst), checked


def record_ln_plain_calls():
    """From now on, (consumer dtype, grad enabled, reason) of each on-card
    call that ``ops/layer_norm.plain_reason`` sends to the plain
    version."""
    calls, rule = [], ln_mod.plain_reason

    def recorded(x, consumer):
        reason = rule(x, consumer)
        if reason is not None and x.device.type == "cuda":
            calls.append((ln_mod._dtype(consumer), torch.is_grad_enabled(),
                          reason))
        return reason

    ln_mod.plain_reason = recorded
    return calls


def record_plain_calls():
    """From now on, (q_all dtype, reason) of each on-card call that
    ``ops/cross_attend.plain_reason`` sends to the plain version."""
    calls, rule = [], ca_mod.plain_reason

    def recorded(mod, q_all, kv_real, kv_unc):
        reason = rule(mod, q_all, kv_real, kv_unc)
        if reason is not None and q_all.device.type == "cuda":
            calls.append((q_all.dtype, reason))
        return reason

    ca_mod.plain_reason = recorded
    return calls


def cross_at_geometries(geoms):
    """The kernel against its plain version and the witness at each
    ``ca_mod.geometry`` of ``geoms``; the worst gaps."""
    mod = MultiheadAttention(PRODUCTION["denoiser"]["text_encoded_dim"], 1,
                             torch.bfloat16).cuda()
    worst = {}
    for i, geom in enumerate(sorted(geoms)):
        _worst(worst, cross_check(mod, geom, 51 + i))
    return worst


def _noise(rng, n_steps, shape):
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    steps = torch.from_numpy(
        rng.standard_normal((n_steps,) + shape).astype(np.float32))
    return init, steps


def phase_parity():
    """Same seeded weights, inputs and noise on the card and on the CPU, in
    fp32 with TF32 off.  GEMM summation order differs between cuBLAS and
    the CPU BLAS; the guidance combine scales each branch's rounding by
    gs * 5 = 37.5 and the steps with x0 clipping compound it.  On an H100
    the motion (|motion| <= 3.2) differed by 4.8e-5 after 50 steps:
    PARITY_ATOL leaves 20x headroom, more at PARITY_STEPS."""
    b = 2
    raw = synthetic_raw_batch(11, b, mel_frames=PRODUCTION["mel_frames"])
    init, steps = _noise(np.random.default_rng(12), PARITY_STEPS,
                         (b, 16, PRODUCTION["latent_dim"][1]))
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = Convofusion(PRODUCTION, dtype="float32", device=device,
                            seed=0)
        batch, _, _ = prepare_arrays(model, raw)
        launches = COUNTS["guided_step.launches"]
        motion, latents = model.sample(
            batch, num_inference_steps=PARITY_STEPS, init_noise=init,
            step_noise=steps)
        if device == "cuda" and COUNTS["guided_step.launches"] - launches \
                != PARITY_STEPS:
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
    log(f"# parity: fp32 DDIM-{PARITY_STEPS} batch {b} card vs CPU: "
        f"max|motion "
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
    for k, side in enumerate((device, "cpu")):
        model = Convofusion(PRODUCTION, dtype="float32", device=side,
                            seed=0)
        batch, _, tb_lsn = prepare_arrays(model, raw)
        fi, fv = focus_word_indices(
            tb_lsn.word_map(model.tokenizer.wrapped_texts(raw["text_lsn"])),
            [list(w) for w in words], max_indices=8)
        # the card runs each case twice: its WEG gradient is deterministic,
        # so the second run must give the same bits
        repeats = 2 if k == 0 else 1
        for name, params in (("config", None), ("forced", WEG_FORCED)):
            outs = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                model.weg_counts = type(model.weg_counts)()
                launches = COUNTS["guided_step.launches"]
                motion, latents = model.sample(
                    batch, num_inference_steps=WEG_STEPS, init_noise=init,
                    step_noise=steps, focus={"focus_idx": fi,
                                             "focus_valid": fv},
                    weg_params=params)
                if side != "cpu" and COUNTS["guided_step.launches"] \
                        - launches != WEG_STEPS:
                    raise RuntimeError("WEG parity run on the card missed "
                                       "the kernel")
                outs.append((motion.float().cpu(), latents.cpu(),
                             model.weg_counts))
                log(f"# weg_parity: {name} parameters on {side}: "
                    f"{time.perf_counter() - t0:.1f} s, {model.weg_counts}")
            if repeats > 1:
                same = all(torch.equal(a, b) for a, b in zip(outs[0][:2],
                                                             outs[1][:2]))
                log(f"# weg_parity: {name}: two runs on {side} from the same "
                    f"noise: motion and latents bit-equal: {same}")
                if not same:
                    raise RuntimeError(f"WEG on {side} is not reproducible: "
                                       f"{name} runs differ")
            runs[k, name] = outs[0]
        if k == 0:
            weg_step_cost(model, batch, fi, fv)
        del model
    log(f"# weg_parity: focus words {words}, valid columns "
        f"{fv.sum(axis=1).tolist()}")
    worst = 0.0
    for name in ("config", "forced"):
        (m_gpu, l_gpu, c_gpu), (m_cpu, l_cpu, c_cpu) = (
            runs[0, name], runs[1, name])
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


def _select_columns_gather(p, idx):
    """models/weg.select_columns as a gather, whose backward is a
    scatter-add with atomics on the card (the earlier form)."""
    idx = idx.long()
    return torch.gather(p, 2, idx[:, None, :].expand(
        p.shape[0], p.shape[1], idx.shape[1]))


def _smooth_conv(p, eot_idx, kernel_size=3, sigma=0.5):
    """models/weg.sliced_reflect_smooth with a gather, F.pad's reflect mode
    and F.conv2d (the earlier form)."""
    b, tq, tk = p.shape
    j = torch.arange(tk, device=p.device)[None, :]
    eot = eot_idx[:, None].long()
    src = torch.where(j == 0, 2, torch.where(j == eot, eot - 2, j))
    p_ext = _select_columns_gather(p, src.clamp(0, tk - 1))
    k = torch.as_tensor(gaussian_kernel_2d(kernel_size, sigma),
                        dtype=p.dtype, device=p.device)
    pad = kernel_size // 2
    x = F.pad(p_ext, (0, 0, pad, pad), mode="reflect")
    x = F.pad(x, (pad, pad))
    out = F.conv2d(x[:, None], k[None, None])[:, 0]
    return out * ((j >= 1) & (j < eot))[:, None, :]


@contextlib.contextmanager
def weg_gather_forms():
    """While open, WEG's focus loss runs its earlier, non-deterministic
    forms: only to time the deterministic ones against them."""
    saved = weg_lib.select_columns, weg_lib.sliced_reflect_smooth
    weg_lib.select_columns = _select_columns_gather
    weg_lib.sliced_reflect_smooth = _smooth_conv
    try:
        yield
    finally:
        weg_lib.select_columns, weg_lib.sliced_reflect_smooth = saved


def weg_step_cost(model, batch, fi, fv):
    """One WEG step's loss and gradient (the text-only pass, its backward
    and the focus loss) with the deterministic forms and with the earlier
    gather forms, in turns: wall ms (median of WEG_COST_CALLS, synced) and
    kernels and device ms from one profiled call each."""
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    with torch.no_grad():
        cond, masks = model.encode_conditions(*(batch[k] for k in keys))
        unc, umasks = model.encode_uncond(batch)
    weg = model.weg_inputs({"focus_idx": fi, "focus_valid": fv}, cond,
                           masks, unc, umasks)

    def text_only_att(lat, t):
        return model.denoiser.text_only(lat, t, weg["cond_text"],
                                        weg["masks_text"])[1]["tlsn"]

    # one loss for both forms: it looks the module's functions up at call
    # time
    loss_grad = weg_lib.value_and_grad(weg_lib.make_weg_loss(
        text_only_att, weg["focus_idx"], weg["focus_valid"],
        weg["eot_idx"]))
    lat = torch.randn((fi.shape[0], 16, model.latent_dim),
                      generator=torch.Generator(device=model.device)
                      .manual_seed(34), device=model.device)
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    forms = {"deterministic": contextlib.nullcontext,
             "gather": weg_gather_forms}
    walls = {name: [] for name in forms}
    grads = {}
    for _ in range(WEG_COST_CALLS):
        for name, form in forms.items():
            with form():
                sync()
                t0 = time.perf_counter()
                _, grads[name] = loss_grad(lat, 981)
                sync()
                walls[name].append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    for name, form in forms.items():
        with form(), profile(activities=activities) as prof:
            loss_grad(lat, 981)
            sync()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        log(f"# weg_parity: one WEG step (text-only pass, backward, focus "
            f"loss), fp32 batch {fi.shape[0]}, {name} forms: "
            f"{statistics.median(walls[name]):.2f} ms (median of "
            f"{WEG_COST_CALLS}), {sum(e.count for e in kernels)} kernels, "
            f"{sum(_device_us(e) for e in kernels) / 1e3:.3f} ms of device "
            f"time")
    gap = float((grads["deterministic"] - grads["gather"]).abs().max())
    log(f"# weg_parity: the two forms' gradients differ by {gap:.3g} "
        f"(|grad| <= {float(grads['gather'].abs().max()):.3g})")


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
    the service's batches and the 2 direct calls."""
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
        COUNTS["guided_step.launches"] = 0
        reqs = _serve_requests(SERVE_TIMED_BATCHES * BATCH, 41)
        motions, wall = _submit_from_clients(svc, reqs, SERVE_CLIENTS)
        _check_served(motions, "serve")
        st = svc.stats()
        launches = COUNTS["guided_step.launches"]
        if st["requests"] != SERVE_TIMED_BATCHES * BATCH or \
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
            if http_st["requests"] != \
                    SERVE_TIMED_BATCHES * BATCH + SERVE_HTTP_REQUESTS:
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
        for name, f in (("with focus", focus), ("without focus", None)):
            t0 = time.perf_counter()
            motion, _ = sampler(to_tensors(arrays, model.device), gen,
                                focus=f)
            if on_card:
                torch.cuda.synchronize()
            direct.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            _check_served(list(motion.float().cpu().numpy()), "direct")
        launches = COUNTS["guided_step.launches"]
        if on_card and launches != STEPS * (http_st["batches"] + 2):
            raise RuntimeError(f"serve: {launches} kernel launches over "
                               f"{http_st['batches']} service batches and 2 "
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


@contextlib.contextmanager
def sampler_calls(device):
    """While open, every CachedSampler call (a rollout's window) is
    recorded: its latents, its wall time up to the motion on the device
    (synchronised) and its step-kernel launches."""
    calls = []
    call = CachedSampler.__call__

    def recording(self, *args, **kwargs):
        launches = COUNTS["guided_step.launches"]
        t0 = time.perf_counter()
        motion, latents = call(self, *args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        calls.append(dict(latents=latents.cpu(),
                          seconds=time.perf_counter() - t0,
                          launches=COUNTS["guided_step.launches"]
                          - launches,
                          call=(self, args, kwargs)))
        return motion, latents

    CachedSampler.__call__ = recording
    try:
        yield calls
    finally:
        CachedSampler.__call__ = call


def _window_noise(rng, n_windows, n_steps, shape):
    return [_noise(rng, n_steps, shape) for _ in range(n_windows)]


def _check_windows(outs, shape, what):
    for k, o in enumerate(outs):
        if o.shape != shape or not np.isfinite(o).all():
            raise RuntimeError(f"{what}: window {k} motion {o.shape} not "
                               f"finite or misshapen")


def _root_gap(outs):
    """max |root xz of window k frame 0 - window k-1 frame 64|."""
    return max((float(np.abs(outs[k][:, 0, [0, 2]]
                             - outs[k - 1][:, 64, [0, 2]]).max())
                for k in range(1, len(outs))), default=0.0)


def phase_rollout_parity(device="cuda"):
    """The rollout on the card and on the CPU from the same seeded weights,
    long batch and per-window noise, fp32, TF32 off, without and with
    'random' WEG.  Each window is phase 6's case: a DDIM-10 sample, here
    with the previous window's latents inpainted, so the card-vs-CPU gap
    of window k-1's latents enters window k through its preseq; the
    per-window gaps are printed to show whether the chain grows them.
    Motion is held to 1e-3 and latents to 2e-3, as phase 6 holds them."""
    b = 2
    batch = synthetic_long_batch(61, b, n_parts=ROLLOUT_PARITY_PARTS)
    n_windows = 2 * ROLLOUT_PARITY_PARTS - 1
    noise = _window_noise(np.random.default_rng(62), n_windows,
                          ROLLOUT_PARITY_STEPS,
                          (b, 16, PRODUCTION["latent_dim"][1]))
    runs = {}
    for side in (device, "cpu"):
        model = Convofusion(PRODUCTION, dtype="float32", device=side,
                            seed=0)
        for weg_type in ("no", "random"):
            t0 = time.perf_counter()
            model.weg_counts = type(model.weg_counts)()
            with sampler_calls(model.device) as calls:
                outs = rollout(model, batch,
                               num_inference_steps=ROLLOUT_PARITY_STEPS,
                               weg_type=weg_type, verbose=False,
                               rng=random.Random(63), noise=noise)
            _check_windows(outs, (b, 128, 189), "rollout parity")
            per_window = [c["launches"] for c in calls]
            if side != "cpu" and \
                    per_window != [ROLLOUT_PARITY_STEPS] * n_windows:
                raise RuntimeError(f"rollout parity on the card: kernel "
                                   f"launches a window {per_window}")
            runs[side, weg_type] = (outs, [c["latents"] for c in calls],
                                    model.weg_counts)
            log(f"# rollout_parity: {weg_type} WEG on {side}: "
                f"{time.perf_counter() - t0:.1f} s, {model.weg_counts}, "
                f"kernel launches a window {per_window}, root xz gap "
                f"{_root_gap(outs):.3g}")
        del model
    for weg_type in ("no", "random"):
        (m_gpu, l_gpu, c_gpu), (m_cpu, l_cpu, c_cpu) = (
            runs[device, weg_type], runs["cpu", weg_type])
        if c_gpu != c_cpu:
            raise RuntimeError(f"rollout WEG counts differ: card {c_gpu}, "
                               f"CPU {c_cpu}")
        gap = _root_gap(m_gpu)
        dm = [float(np.abs(g - c).max()) for g, c in zip(m_gpu, m_cpu)]
        dl = [float((g - c).abs().max()) for g, c in zip(l_gpu, l_cpu)]
        log(f"# rollout_parity: {weg_type} WEG, fp32 DDIM-"
            f"{ROLLOUT_PARITY_STEPS} batch {b}, {n_windows} windows, card "
            f"vs CPU: max|motion diff| a window {[f'{d:.3g}' for d in dm]} "
            f"(|motion| <= {max(float(np.abs(m).max()) for m in m_cpu):.3g})"
            f", max|latent diff| a window {[f'{d:.3g}' for d in dl]}; root "
            f"xz gap {gap:.3g}; tolerances {ROLLOUT_MOTION_ATOL} (motion), "
            f"{ROLLOUT_LATENT_ATOL} (latents), 1e-4 (root)")
        if not max(dm) <= ROLLOUT_MOTION_ATOL:
            raise RuntimeError(f"rollout card vs CPU motion differ by {dm}")
        if not max(dl) <= ROLLOUT_LATENT_ATOL:
            raise RuntimeError(f"rollout card vs CPU latents differ by {dl}")
        if not gap <= 1e-4:
            raise RuntimeError(f"rollout root xz gap {gap}")


def phase_rollout(smi, device=None):
    """bench.py --mode rollout on the port: bf16 batch 96, DDIM-50, with
    ROLLOUT_PARTS parts (bench.py's 3, cut to keep the run in its time);
    the warm-up and the WEG rollout of ROLLOUT_SHORT_PARTS."""
    model = Convofusion(PRODUCTION, dtype="bfloat16", device=device, seed=1)
    dev = model.device
    on_card = dev.type == "cuda"
    batches = {n: synthetic_long_batch(0, BATCH, n_parts=n)
               for n in (ROLLOUT_PARTS, ROLLOUT_SHORT_PARTS)}
    gen = torch.Generator(device=dev).manual_seed(64)
    encodes = []
    encode = model.encode_uncond
    model.encode_uncond = lambda b: encodes.append(1) or encode(b)
    if on_card:
        # no gc.collect(): a cached sampler holds its model weakly, so
        # phase 8's models went with their last reference
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for i, weg_type in enumerate(["no"] * (1 + ROLLOUT_TIMED) + ["random"]):
        timed = 0 < i <= ROLLOUT_TIMED
        parts = ROLLOUT_PARTS if timed else ROLLOUT_SHORT_PARTS
        batch, n_windows = batches[parts], 2 * parts - 1
        before_enc, before = len(encodes), COUNTS["guided_step.launches"]
        model.weg_counts = type(model.weg_counts)()
        t0 = time.perf_counter()
        with sampler_calls(dev) as calls:
            outs = rollout(model, batch, gen, num_inference_steps=STEPS,
                           weg_type=weg_type, verbose=False,
                           rng=random.Random(65))
        wall = time.perf_counter() - t0
        n_launch = COUNTS["guided_step.launches"] - before
        n_enc = len(encodes) - before_enc
        _check_windows(outs, (BATCH, 128, 189), "rollout")
        if on_card and n_launch != STEPS * n_windows:
            raise RuntimeError(f"rollout {i}: {n_launch} kernel launches, "
                               f"want {STEPS * n_windows}")
        # one encode by each sampler's first window, then the cache
        first = i in (0, 1 + ROLLOUT_TIMED)
        if n_enc != (1 if first else 0):
            raise RuntimeError(f"rollout {i}: {n_enc} uncond encodes")
        sampler_s = sum(c["seconds"] for c in calls)
        host_ms = (wall - sampler_s) / n_windows * 1e3
        rows.append((weg_type, wall, n_windows))
        log(f"# rollout: {'warm-up ' if i == 0 else ''}{weg_type} WEG: "
            f"{wall * 1e3:.1f} ms, {BATCH * n_windows / wall:.2f} windows/s, "
            f"{wall / n_windows * 1e3:.1f} ms a window (sampler "
            f"{sampler_s / n_windows * 1e3:.1f} ms, host {host_ms:.1f} ms, "
            f"{(wall - sampler_s) / wall:.1%}); {n_launch} kernel launches, "
            f"{n_enc} uncond encodes, {model.weg_counts}")
        if timed:
            last_window = calls[-1]["call"]
    model.encode_uncond = encode

    # the last window's sampler call again, with and without its preseq:
    # what inpainting adds to a window's sample()
    sampler, args, kwargs = last_window
    direct = {}
    for name in ("with preseq", "without preseq"):
        t0 = time.perf_counter()
        sampler(*args, **{**kwargs, "preseq": kwargs["preseq"]
                          if name == "with preseq" else None})
        if on_card:
            torch.cuda.synchronize()
        direct.setdefault(name, []).append(
            round((time.perf_counter() - t0) * 1e3, 1))
    log(f"# rollout: the last window's sample() alone: {direct} ms")
    n_windows = 2 * ROLLOUT_PARTS - 1
    med = statistics.median(w for _, w, _ in rows[1:1 + ROLLOUT_TIMED])
    _, weg_wall, weg_windows = rows[-1]
    # a window's wall with WEG over one without
    weg_x = (weg_wall / weg_windows) / (med / n_windows)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"# rollout: bf16 batch {BATCH} {ROLLOUT_PARTS} parts ({n_windows} "
        f"windows) DDIM-{STEPS} on {smi}: {BATCH * n_windows / med:.2f} "
        f"windows/s, {med / n_windows * 1e3:.1f} ms a window (median of "
        f"{ROLLOUT_TIMED}); with WEG ({weg_windows} window) "
        f"{BATCH * weg_windows / weg_wall:.2f} windows/s ({weg_x:.2f}x); "
        f"peak memory {peak / 2**30:.2f} GiB")


def phase_dpmpp(smi, device="cuda"):
    """DPM-Solver++ 2M: fp32 batch 2 card vs CPU, then bf16 batch 96
    timing.  Its plain combine and update replace the fused kernel (JAX's
    gate), so no launch may happen.  Card vs CPU, as phase 4 argues, but at
    20 steps; held to 1e-3 (motion) and 2e-3 (latents)."""
    cfg = copy.deepcopy(PRODUCTION)
    cfg["scheduler"]["variant"] = "dpmpp_2m"
    b = 2
    raw = synthetic_raw_batch(71, b, mel_frames=cfg["mel_frames"])
    init = torch.from_numpy(np.random.default_rng(72).standard_normal(
        (b, 16, cfg["latent_dim"][1])).astype(np.float32))
    before = COUNTS["guided_step.launches"]
    out = {}
    for side in (device, "cpu"):
        model = Convofusion(cfg, dtype="float32", device=side, seed=0)
        batch, _, _ = prepare_arrays(model, raw)
        motion, latents = model.sample(batch, num_inference_steps=DPMPP_STEPS,
                                       init_noise=init)
        out[side] = (motion.float().cpu(), latents.cpu())
        del model
    (m_gpu, l_gpu), (m_cpu, l_cpu) = out[device], out["cpu"]
    for t in (m_gpu, m_cpu):
        if t.shape != (b, 128, 189) or not torch.isfinite(t).all():
            raise RuntimeError("dpmpp motion not finite or misshapen")
    dm = float((m_gpu - m_cpu).abs().max())
    dl = float((l_gpu - l_cpu).abs().max())
    log(f"# dpmpp: fp32 dpmpp_2m-{DPMPP_STEPS} batch {b} card vs CPU: "
        f"max|motion diff| {dm:.3g} (|motion| <= "
        f"{float(m_cpu.abs().max()):.3g}), max|latent diff| {dl:.3g}; "
        f"tolerances {DPMPP_ATOL} (motion), {DPMPP_LATENT_ATOL} (latents)")
    if not dm <= DPMPP_ATOL or not dl <= DPMPP_LATENT_ATOL:
        raise RuntimeError(f"dpmpp card vs CPU differ by {dm} / {dl}")

    model = Convofusion(cfg, dtype="bfloat16", device=device, seed=1)
    on_card = model.device.type == "cuda"
    raw = synthetic_raw_batch(21, BATCH, mel_frames=cfg["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    gen = torch.Generator(device=model.device).manual_seed(73)
    sampler = model.cached_sampler(DPMPP_STEPS)
    times = []
    for call in range(1 + TIMED_CALLS):
        t0 = time.perf_counter()
        motion, _ = sampler(batch, gen)
        if on_card:
            torch.cuda.synchronize()
        if call:
            times.append(time.perf_counter() - t0)
        if tuple(motion.shape) != (BATCH, 128, 189) or \
                not torch.isfinite(motion).all():
            raise RuntimeError("dpmpp batch motion misshapen or not finite")
    launches = COUNTS["guided_step.launches"] - before
    if launches:
        raise RuntimeError(f"dpmpp launched the step kernel {launches} "
                           f"times")
    med = statistics.median(times)
    log(f"# dpmpp: bf16 batch {BATCH} dpmpp_2m-{DPMPP_STEPS} on {smi}: "
        f"{BATCH / med:.2f} clips/s, {med * 1e3:.1f} ms/call (median of "
        f"{TIMED_CALLS}: {[round(t * 1e3, 1) for t in times]}), 0 kernel "
        f"launches")
    return model, sampler, batch, gen


def dpmpp_against_ddim(model, sampler, batch, gen):
    """Phase 10's model and batch at DDIM-20 (through the kernel) in turns
    with dpmpp_2m-20: what the sampler itself costs a step.  Run after
    phase 10's launches are read."""
    on_card = model.device.type == "cuda"
    dpmpp = model.scheduler
    ddim = dataclasses.replace(dpmpp, variant="ddim")
    turns = {}
    for name, sched in (("ddim", ddim), ("dpmpp_2m", dpmpp)) * 2:
        model.scheduler = sched
        t0 = time.perf_counter()
        sampler(batch, gen)
        if on_card:
            torch.cuda.synchronize()
        turns.setdefault(name, []).append(
            round((time.perf_counter() - t0) * 1e3, 1))
    model.scheduler = dpmpp
    log(f"# dpmpp: in turns at {DPMPP_STEPS} steps, ms/call: {turns}")


def without_dropout(cfg):
    """``cfg`` with every dropout rate 0: the masks come from each
    device's own generator, so only a dropout-free step compares."""
    cfg = copy.deepcopy(cfg)
    for block in ("denoiser", "motion_vae", "audio_encoder"):
        cfg[block]["dropout"] = 0.0
    return cfg


def train_draws(rng, stage, b, n_steps, lat=128):
    """Numpy-made draws for ``n_steps`` steps: the VAE's eps and, in stage
    2, the modality-dropout groups (any of the 7 per row), the noise and
    the timesteps."""
    out = []
    for _ in range(n_steps):
        d = {"eps": rng.standard_normal((2, b, 8, lat)).astype(np.float32)}
        if stage != "vae":
            d.update(group=rng.integers(0, 7, b),
                     noise=rng.standard_normal((b, 16, lat)).astype(
                         np.float32),
                     timesteps=rng.integers(0, 1000, b))
        out.append(d)
    return out


def train_batch(model, raw):
    """The batch of ``model``'s stage: motion alone for stage 1."""
    if model.stage == "vae":
        return {"motion": to_tensors({"m": raw["motion_lsn"]},
                                     model.device)["m"]}
    return prepare_arrays(model, raw)[0]


def _grad_worst(got, want):
    """The worst gradient's gap over its tolerance (phase 11's), and its
    name."""
    worst, worst_name = 0.0, None
    for name, w in want.items():
        tol = TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(w.abs().max())
        ratio = float((got[name] - w).abs().max()) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def phase_train_parity(device="cuda"):
    """Stage 1 and stage 2 (token ids), fp32 with TF32 off, production
    geometry, batch 4, dropout 0, the same seeded weights and numpy-made
    draws on the card and on the CPU.  GEMM sums run in another order on
    each, and the embedding and gather backwards add with atomics on the
    card: the step-1 loss is held to 1e-4 relative, every gradient to
    1e-5 + 1e-3 max|g| of its tensor, and the losses of 3 AdamW steps to
    1e-3 relative (AdamW divides by sqrt(v), which magnifies the gap of a
    near-zero gradient, so parameters are not compared)."""
    b = TRAIN_PARITY_BATCH
    raw = synthetic_raw_batch(31, b, mel_frames=PRODUCTION["mel_frames"])
    for stage, cfg in (("vae", PRODUCTION_VAE), ("diffusion", PRODUCTION)):
        draws = train_draws(np.random.default_rng(32), stage, b,
                            TRAIN_PARITY_STEPS, cfg["latent_dim"][1])
        out = {}
        for side in (device, "cpu"):
            t0 = time.perf_counter()
            model = Convofusion(without_dropout(cfg), dtype="float32",
                                device=side, seed=0, stage=stage)
            batch = train_batch(model, raw)
            trained = {n for n, _ in trainable_parameters(model, stage)}
            frozen = {n: p.detach().clone()
                      for n, p in model.named_parameters()
                      if n not in trained}
            trainer = Trainer(model)
            trainer.init_state()
            with trainer.training():
                loss, _ = trainer.compute_grads(batch, None, draws[0])
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
                trainer.apply_grads()
            losses = [float(loss)] + trainer.fit_steps(
                [batch] * (TRAIN_PARITY_STEPS - 1), None, log_every=1,
                draws=draws[1:])
            changed = [n for n, p in model.named_parameters()
                       if n in frozen and not torch.equal(p, frozen[n])]
            if changed:
                raise RuntimeError(f"train_parity {stage} on {side}: frozen "
                                   f"parameters moved: {changed[:4]}")
            if set(grads) != trained:
                raise RuntimeError(f"train_parity {stage} on {side}: "
                                   f"{len(grads)} gradients for "
                                   f"{len(trained)} trainable parameters")
            out[side] = (losses, grads)
            log(f"# train_parity: {stage} {TRAIN_PARITY_STEPS} steps on "
                f"{side} in {time.perf_counter() - t0:.1f} s ({len(frozen)} "
                f"frozen tensors unchanged)")
            del model, trainer
        (l_gpu, g_gpu), (l_cpu, g_cpu) = out[device], out["cpu"]
        if not all(np.isfinite(l_gpu + l_cpu)):
            raise RuntimeError(f"train_parity {stage}: losses not finite")
        d_loss = abs(l_gpu[0] - l_cpu[0]) / abs(l_cpu[0])
        worst, worst_name = _grad_worst(g_gpu, g_cpu)
        d_fit = max(abs(a - c) / abs(c) for a, c in zip(l_gpu, l_cpu))
        log(f"# train_parity: {stage} fp32 batch {b} card vs CPU: step-1 "
            f"loss {l_cpu[0]:.6g}, relative gap {d_loss:.3g} (tolerance "
            f"{TRAIN_LOSS_RTOL}); {len(g_cpu)} gradients, the worst at "
            f"{worst:.3g} of its tolerance ({worst_name}); losses of "
            f"{TRAIN_PARITY_STEPS} steps {[round(x, 6) for x in l_gpu]} "
            f"card, {[round(x, 6) for x in l_cpu]} CPU, relative gap "
            f"{d_fit:.3g} (tolerance {TRAIN_FIT_RTOL})")
        if not d_loss <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"train_parity {stage}: loss gap {d_loss}")
        if not worst <= 1.0:
            raise RuntimeError(f"train_parity {stage}: gradient "
                               f"{worst_name} at {worst} x its tolerance")
        if not d_fit <= TRAIN_FIT_RTOL:
            raise RuntimeError(f"train_parity {stage}: step losses gap "
                               f"{d_fit}")


def cached_layout(model, batch):
    """bench.py --cached-text --cached-vae (bench.py:388-416): the T5 trunk
    states with a one-row uncond trunk, and the frozen VAE's posterior, in
    place of the token ids and the motion."""
    out = dict(batch)
    for who in ("spk", "lsn"):
        out[f"{who}_trunk"] = model.encode_text_trunk(
            batch[f"{who}_ids"], batch[f"{who}_tmask"])
    out["uncond_trunk"] = model.encode_text_trunk(batch["uncond_ids"][:1],
                                                  batch["uncond_tmask"][:1])
    out["uncond_tmask"] = batch["uncond_tmask"][:1]
    out["vae_mu"], out["vae_logvar"] = model.encode_vae_posterior(
        batch["motion_lsn"])
    for k in ("spk_ids", "lsn_ids", "uncond_ids", "motion_lsn"):
        del out[k]
    return out


def time_training(name, model, batch, smi, seed, adamw_checks=True):
    """TRAIN_WARMUP + TRAIN_TIMED steps, each ending in a sync (graphed
    on the card from the second), TRAIN_COMPARED graphed steps against as
    many eager ones from one state, the optimizer graph's kernels, then
    TRAIN_PROFILED eager steps under the profiler; with ``adamw_checks``,
    after the step's peak memory is read, the AdamW kernel against its
    plain version and its times.  Returns a summary."""
    dev = model.device
    on_card = dev.type == "cuda"
    b = (batch["motion"] if model.stage == "vae"
         else batch["lsn_tmask"]).shape[0]
    trainer = Trainer(model)
    trainer.init_state()
    gen = torch.Generator(device=dev).manual_seed(seed)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    counts = _graph_counts()
    with trainer.training():
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            t0 = time.perf_counter()
            loss, _ = trainer.compute_grads(batch, gen)
            trainer.apply_grads()
            if on_card:
                torch.cuda.synchronize()
            losses.append(loss)
            if i >= TRAIN_WARMUP:
                times.append(time.perf_counter() - t0)
        counts = _graph_counts(counts)
        # the warm-up step launches the AdamW kernel, the capture records
        # it (counted once), the replays launch none from the host
        if on_card and counts["launches"] != 2:
            raise RuntimeError(f"train {name}: {counts['launches']} AdamW "
                               f"launches counted over the timed steps, "
                               f"want 2")
        graphed_against_eager(trainer, batch, gen, name)
        optimizer_graph_kernels(trainer, batch, gen, name)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        # eager: each kernel launched and counted on its own
        with eager_graphs(), profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILED):
                loss, _ = trainer.compute_grads(batch, gen)
                trainer.apply_grads()
                losses.append(loss)
            if on_card:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        split = split_step(trainer, batch, gen, on_card)
        check_no_host_wait(trainer, batch, gen, on_card, name)
        with eager_graphs(), default_generator_dropout(), profile(
                activities=activities) as fused_prof:
            trainer.compute_grads(batch, gen)
            trainer.apply_grads()
            if on_card:
                torch.cuda.synchronize()
    fused_kernels = sum(e.count for e in fused_prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation)
    averages = prof.key_averages()
    # device rows but the spans' device-side ranges, which cover the gaps
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    # kernel time a step from the profiled steps; the profiler slows the
    # host, so the busy share divides the union of the kernels' intervals
    # by the unprofiled median step
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / TRAIN_PROFILED
    busy_ms = _union_ms(prof.events()) / TRAIN_PROFILED
    n_kernels = sum(e.count for e in kernels) // TRAIN_PROFILED
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    med = statistics.median(times)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError(f"train {name}: a loss is not finite")
    summary = dict(ms=med * 1e3, clips_per_s=b / med, peak_gib=peak / 2**30,
                   kernels=n_kernels, fused_dropout_kernels=fused_kernels,
                   device_ms=device_ms, busy_ms=busy_ms,
                   busy=busy_ms / (med * 1e3), graph_counts=counts)
    log(f"# train: {name}, batch {b}, bf16 + fp32 masters, on {smi}: "
        f"{med * 1e3:.2f} ms a step (median of {TRAIN_TIMED}; "
        f"{min(times) * 1e3:.2f}-{max(times) * 1e3:.2f}), "
        f"{b / med:.1f} clips/s, peak memory {peak / 2**30:.2f} GiB, "
        f"{n_kernels} kernels a step, {device_ms:.2f} ms of kernel time a "
        f"step summed by kernel, {busy_ms:.2f} ms in which one runs, "
        f"the card busy {busy_ms / (med * 1e3):.1%} of the median step "
        f"(kernel time from {TRAIN_PROFILED} profiled eager steps, "
        f"which took {wall_ms / TRAIN_PROFILED:.1f} ms each under the "
        f"profiler); losses {float(losses[0]):.4g} -> "
        f"{float(losses[-1]):.4g}; graph counters over the "
        f"{TRAIN_WARMUP + TRAIN_TIMED} timed steps {counts}")
    log(f"# train: {name}: {n_kernels} kernels a step with the dropout "
        f"masks drawn from the step's generator, {fused_kernels} with "
        f"F.dropout's fused kernel from the default generator (one profiled "
        f"step): {n_kernels - fused_kernels:+d}")
    log(f"# train: {name}: one step split with a sync between the parts: "
        f"forward {split[0]:.1f} ms, backward {split[1]:.1f} ms, AdamW and "
        f"the master copy {split[2]:.1f} ms"
        f"{'; no wait for the card inside a step (CUDA sync checker)' if on_card else ''}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"#   {_device_us(e) / 1e3 / TRAIN_PROFILED:8.3f} ms a step "
            f"{e.count // TRAIN_PROFILED:5d}x  {e.key[:90]}")
    host = [e for e in averages if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"#   host {e.self_cpu_time_total / 1e3 / TRAIN_PROFILED:8.3f} "
            f"ms a step {e.count // TRAIN_PROFILED:5d}x  {e.key[:80]}")
    if adamw_checks:
        adamw_against_plain(trainer, name)
        adamw_times(trainer, name)
    return summary


def _graph_counts(before=None):
    """The training graphs' counters, or their change since ``before``."""
    now = {k.split(".")[1]: COUNTS[k] for k in TRAIN_GRAPH_COUNTERS}
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def graphed_against_eager(trainer, batch, gen, name):
    """TRAIN_COMPARED eager steps, then as many graphed ones from the same
    state (the masters and moments, the weights rounded from them, the
    mask generator): bit-equal losses and masters required, and on the
    card one replay of each graph a graphed step, no capture (the timed
    steps captured) and no eager call."""
    state = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in trainer.state_dict().items()}
    gen_state = gen.get_state()
    out = {}
    for mode in ("eager", "graphed"):
        trainer.load_state_dict(state)
        gen.set_state(gen_state)
        before = _graph_counts()
        with eager_graphs() if mode == "eager" else \
                contextlib.nullcontext():
            losses = []
            for _ in range(TRAIN_COMPARED):
                loss, _ = trainer.compute_grads(batch, gen)
                trainer.apply_grads()
                losses.append(loss)
        out[mode] = (torch.stack(losses), [m.clone() for m in
                                           trainer.masters],
                     _graph_counts(before))
    (l_e, m_e, c_e), (l_g, m_g, c_g) = out["eager"], out["graphed"]
    differ = [n for n, a, b in zip(trainer.names, m_e, m_g)
              if not torch.equal(a, b)]
    log(f"# train: {name}: {TRAIN_COMPARED} graphed steps against as many "
        f"eager ones from one state: losses {l_g.tolist()} / "
        f"{l_e.tolist()}, bit-equal {torch.equal(l_g, l_e)}; "
        f"{len(m_g) - len(differ)} of {len(m_g)} masters bit-equal; graph "
        f"counters graphed {c_g}, eager {c_e}")
    if not torch.equal(l_g, l_e) or differ:
        raise RuntimeError(f"train {name}: graphed steps differ from eager "
                           f"ones: losses {l_g.tolist()} / {l_e.tolist()}, "
                           f"masters {differ[:4]}")
    if trainer.model.device.type == "cuda":
        # the AdamW kernel: one launch an eager step, none in a replay
        want = {"graph_captures": 0, "graph_replays": 2 * TRAIN_COMPARED,
                "graph_eager": 0, "launches": 0}
        if c_g != want:
            raise RuntimeError(f"train {name}: graph counters {c_g}, want "
                               f"{want}")
        if c_e["launches"] != TRAIN_COMPARED:
            raise RuntimeError(f"train {name}: {c_e['launches']} AdamW "
                               f"launches in {TRAIN_COMPARED} eager steps")


def optimizer_graph_kernels(trainer, batch, gen, name):
    """Two graphed steps under the profiler: the device kernels inside each
    ``train.optimizer`` span's device-side range (``apply_grads``) must be
    the AdamW kernel, the optimizer graph's replay, and the three fills of
    the step's scalars; logs the kernel's device time there."""
    if trainer.model.device.type != "cuda":
        return
    # a profile that caught no device range at all is retried: the
    # profiler drops a window's device events now and then
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer.compute_grads(batch, gen)
                trainer.apply_grads()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ranges = [e.time_range for e in events if e.is_user_annotation
                  and e.name == "train.optimizer"]
        if len(ranges) == 2:
            break
    else:
        raise RuntimeError(f"train {name}: the profiler caught {len(ranges)} "
                           f"device ranges of train.optimizer in 3 tries")
    times = []
    for r in ranges:
        inside = [e for e in events if not e.is_user_annotation
                  and r.start <= e.time_range.start < r.end]
        ours = [e for e in inside if "adamw_kernel" in e.name]
        others = [e.name for e in inside if e not in ours
                  and "fill" not in e.name.lower()]
        if len(ours) != 1 or others:
            raise RuntimeError(f"train {name}: the optimizer graph's replay "
                               f"ran {len(ours)} AdamW kernels and "
                               f"{others[:4]}")
        times.append(ours[0].device_time_total)
    log(f"# train: {name}: the optimizer graph's replay is one AdamW kernel "
        f"of {times[0]:.1f} / {times[1]:.1f} us (two graphed steps; the "
        f"step's three scalar fills beside it)")


def _clones(ts):
    return [None if t is None else t.detach().clone() for t in ts]


def _ulps(a, b):
    """The largest gap of a and b in units of b's spacing, in b's dtype."""
    if a is None:
        return 0.0
    inf = torch.full_like(b, float("inf"))
    spacing = (torch.nextafter(b.abs(), inf) - b.abs()).float()
    return float(((a.float() - b.float()).abs() / spacing).max())


def adamw_against_plain(trainer, name):
    """The AdamW kernel (``adamw.adamw_step``) against the plain chain
    (``adamw.adamw_reference``) on clones of the trainer's masters, moments
    and weights over ADAMW_STEPS steps of seeded gradients in the
    parameters' dtypes: the clip off, with its own norm (the plain version
    given the kernel's, ``adamw.prepass_norm``) and with a given norm.
    Logs each array's max |diff| and ulps; raises beyond ADAMW_FP32_ULPS /
    ADAMW_BF16_ULPS, naming the arrays that differ."""
    dev = trainer.model.device
    if dev.type != "cuda":
        return
    opt = trainer.optimizer
    gen = torch.Generator(device=dev).manual_seed(46)
    grads = [[None if i % ADAMW_ABSENT_EVERY == 3 else
              (torch.randn(p.shape, generator=gen, device=dev)
               * scale).to(p.dtype)
              for i, p in enumerate(trainer.params)]
             for scale in ADAMW_SCALES[:ADAMW_STEPS]]
    start = (trainer.masters, trainer.state.mu, trainer.state.nu,
             [None if p.dtype == torch.float32 else p
              for p in trainer.params])
    for case, (clip, given) in {"clip off": (0.0, False),
                                "clip, own norm": (ADAMW_CLIP, False),
                                "clip, given norm": (ADAMW_CLIP, True)
                                }.items():
        kernel = [_clones(ts) for ts in start]
        plain = [_clones(ts) for ts in start]
        norms = []
        for step, g in enumerate(grads):
            scalars = [torch.tensor(v, dtype=torch.float32, device=dev)
                       for v in opt.scalars(step)]
            fp32 = [torch.zeros_like(m) if x is None else x.float()
                    for x, m in zip(g, kernel[0])]
            own = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(fp32)))
            norm = own if given else None
            table = adamw.make_table(g, *kernel)
            adamw.adamw_step(g, *kernel, scalars, opt.weight_decay, clip,
                             norm, table)
            if clip and not given:
                norm = adamw.prepass_norm(table.partials)
                norms.append((float(norm), _ulps(norm, own),
                              bool(norm < clip)))
            adamw.adamw_reference(g, *plain, scalars, opt.weight_decay,
                                  clip, norm)
        torch.cuda.synchronize()
        gaps, differ = {}, []
        for what, got, want in zip(("masters", "mu", "nu", "weights"),
                                   kernel, plain):
            pairs = [(a, b) for a, b in zip(got, want) if b is not None]
            # one host read an array; ulps only where something differs
            diff = float(torch.stack([(a.float() - b.float()).abs().max()
                                      for a, b in pairs]).max()) \
                if pairs else 0.0
            ulps = max(_ulps(a, b) for a, b in pairs) if diff else 0.0
            gaps[what] = (diff, ulps)
            if diff:
                differ.append(what)
        n = sum(m.numel() for m in start[0])
        log(f"# train: {name}: AdamW kernel against the plain chain, "
            f"{case}, {ADAMW_STEPS} steps over {len(start[0])} tensors "
            f"({n / 1e6:.2f} M parameters): max |diff| (ulps) " + ", ".join(
                f"{k} {d:.3g} ({u:.1f})" for k, (d, u) in gaps.items())
            + (f"; the pre-pass norm (value, ulps from the chain's, kept): "
               f"{norms}" if norms else ""))
        if differ:
            log(f"# train: {name}: {case}: differ in {differ}: mu is "
                f"_foreach_add_'s, nu _foreach_addcmul_'s, the masters "
                f"alone the update's division, sqrt, decay or add, the "
                f"weights alone the bf16 rounding")
        if max(gaps[k][1] for k in ("masters", "mu", "nu")) > \
                ADAMW_FP32_ULPS or gaps["weights"][1] > ADAMW_BF16_ULPS:
            raise RuntimeError(f"train {name}: {case}: the AdamW kernel "
                               f"differs from the plain chain: {gaps}")


def _graph_ms_each(fn):
    """CUDA-event ms a replay of ``fn`` captured as one CUDA graph, over
    ADAMW_TIMED replays back to back after 3 (after one eager call on a
    side stream): the device's time, without the host's launch work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ADAMW_TIMED):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ADAMW_TIMED


def adamw_times(trainer, name):
    """Ms a step back to back over the trainer's trainable set (every
    gradient present, in the parameters' dtypes), each replayed from one
    CUDA graph: the AdamW kernel at each of ADAMW_CHUNKS against the byte
    bound; the plain chain (the earlier optimizer graph, its fp32 casts
    and bf16 copies included); torch._fused_adamw_ over fp32 masters,
    moments and gradients, a yardstick the port never calls."""
    dev = trainer.model.device
    if dev.type != "cuda":
        return
    opt = trainer.optimizer
    gen = torch.Generator(device=dev).manual_seed(47)
    grads = [(torch.randn(p.shape, generator=gen, device=dev)
              * 1e-3).to(p.dtype) for p in trainer.params]
    state = [_clones(ts) for ts in (
        trainer.masters, trainer.state.mu, trainer.state.nu,
        [None if p.dtype == torch.float32 else p for p in trainer.params])]
    scalars = [torch.tensor(v, dtype=torch.float32, device=dev)
               for v in opt.scalars(0)]
    wd = opt.weight_decay
    nbytes = sum(g.numel() * (g.element_size() + 24
                              + (2 if w is not None else 0))
                 for g, w in zip(grads, state[3]))
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    sweep = {}
    for chunk in ADAMW_CHUNKS:
        table = adamw.make_table(grads, *state, chunk=chunk)
        sweep[chunk] = _graph_ms_each(lambda: adamw.adamw_step(
            grads, *state, scalars, wd, 0.0, None, table))
    plain_ms = _graph_ms_each(lambda: adamw.adamw_reference(
        grads, *state, scalars, wd, 0.0))
    fp32 = [g.float() for g in grads]
    steps = [torch.ones((), dtype=torch.float32, device=dev)
             for _ in grads]
    fused_ms = _graph_ms_each(lambda: torch._fused_adamw_(
        state[0], fp32, state[1], state[2], [], steps, lr=7e-5, beta1=0.9,
        beta2=0.999, weight_decay=wd, eps=1e-8, amsgrad=False,
        maximize=False))
    best = min(sweep, key=sweep.get)
    log(f"# train: {name}: AdamW over {len(grads)} tensors, "
        f"{nbytes / 1e9:.3f} GB a step, bound {bound_ms:.3f} ms at "
        f"3.35 TB/s; back to back from CUDA graphs, ms a step: the kernel "
        f"at chunk " + ", ".join(f"{c} {t:.3f}" for c, t in sweep.items())
        + f" (best {best}: {bound_ms / sweep[best]:.1%} of the bound; "
        f"chunk {adamw.CHUNK}: {bound_ms / sweep[adamw.CHUNK]:.1%}); the "
        f"plain chain {plain_ms:.3f}; torch._fused_adamw_ (fp32 "
        f"gradients) {fused_ms:.3f}")
    PHASE_RESULTS.setdefault("adamw", {})[name] = dict(
        tensors=len(grads), gb=nbytes / 1e9, bound_ms=bound_ms,
        kernel_ms=sweep, plain_graph_ms=plain_ms, fused_adamw_ms=fused_ms)


@contextlib.contextmanager
def default_generator_dropout():
    """While open, ``ops/layers.Dropout`` is ``F.dropout`` (one fused
    kernel, masks from the device's default generator), the earlier form:
    only to count the kernels the step's-generator masks add."""
    forward = layers.Dropout.forward

    def fused(self, x):
        if self.training and self.p > 0.0:
            return F.dropout(x, self.p, True)
        return x

    layers.Dropout.forward = fused
    try:
        yield
    finally:
        layers.Dropout.forward = forward


def split_step(trainer, batch, gen, on_card):
    """One step's forward, backward and optimizer times in ms, with a sync
    between the parts (inside ``trainer.training()``)."""
    marks = [time.perf_counter()]

    def mark():
        if on_card:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    loss, _ = trainer.loss_fn()(batch, gen, None)
    mark()
    loss.backward()
    mark()
    trainer.apply_grads()
    mark()
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def check_no_host_wait(trainer, batch, gen, on_card, name):
    """One step with the CUDA sync checker on: any op that makes the host
    wait for the card inside the step (an .item(), a synchronising copy)
    warns; the phase fails on a warning."""
    if not on_card:
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.compute_grads(batch, gen)
            trainer.apply_grads()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    for msg in syncs[:5]:
        log(f"# train: {name}: host wait: {msg[:300]}")
    if syncs:
        raise RuntimeError(f"train {name}: {len(syncs)} host waits in a step")


def phase_train(smi, device=None):
    """bf16 training at the production batch sizes through the Trainer:
    stage 2 with token ids and with the cached layout, stage 1; then the
    stage-1 learning check."""
    rows = {}
    raw2 = synthetic_raw_batch(41, TRAIN_DIFFUSION_BATCH,
                               mel_frames=PRODUCTION["mel_frames"])
    model = Convofusion(PRODUCTION, dtype="bfloat16", device=device, seed=2)
    batch = train_batch(model, raw2)
    rows["stage2_ids"] = time_training("stage 2, token ids", model, batch,
                                       smi, 42)
    del model, batch
    model = Convofusion(PRODUCTION, dtype="bfloat16", device=device, seed=2)
    batch = cached_layout(model, train_batch(model, raw2))
    # the same trainable set as with ids: the AdamW kernel is checked there
    rows["stage2_cached"] = time_training(
        "stage 2, cached T5 trunk and VAE posterior", model, batch, smi, 42,
        adamw_checks=False)
    del model, batch
    raw1 = synthetic_raw_batch(43, TRAIN_VAE_BATCH,
                               mel_frames=PRODUCTION["mel_frames"])
    model = Convofusion(PRODUCTION_VAE, dtype="bfloat16", device=device,
                        seed=3, stage="vae")
    batch = train_batch(model, raw1)
    rows["stage1"] = time_training("stage 1", model, batch, smi, 44)
    ids, cached = rows["stage2_ids"], rows["stage2_cached"]
    log(f"# train: the cached layout saves {1 - cached['ms'] / ids['ms']:.1%}"
        f" of a stage-2 step ({ids['kernels'] - cached['kernels']} kernels "
        f"fewer)")

    # stage 1 on one fixed batch: the loss must come down
    model = Convofusion(PRODUCTION_VAE, dtype="bfloat16", device=device,
                        seed=5, stage="vae")
    gen = torch.Generator(device=model.device).manual_seed(45)
    t0 = time.perf_counter()
    hist = Trainer(model).fit_steps([batch] * LEARN_STEPS, gen, log_every=1)
    first, last = statistics.mean(hist[:5]), statistics.mean(hist[-5:])
    log(f"# train: stage 1, one fixed batch of {TRAIN_VAE_BATCH}, "
        f"{LEARN_STEPS} steps in {time.perf_counter() - t0:.1f} s: mean "
        f"loss of the first 5 {first:.4f}, of the last 5 {last:.4f}, ratio "
        f"{last / first:.3f}")
    if not (np.isfinite(hist).all() and last < first):
        raise RuntimeError(f"stage 1 did not learn: {first} -> {last}")
    return rows


def _bit_equal(a: torch.nn.Module, b: torch.nn.Module, skip=None):
    """Names of the tensors of ``a`` that differ from ``b``'s in any bit
    (``skip``: a name prefix left out)."""
    sb = b.state_dict()
    return [k for k, v in a.state_dict().items()
            if not (skip and k.startswith(skip)) and not torch.equal(
                v, sb[k])]


def _save_timed(*args, **kwargs):
    """save_checkpoint's path and its ms up to the return (and, in the
    background, up to the write's end)."""
    t0 = time.perf_counter()
    path = ckpt_lib.save_checkpoint(*args, **kwargs)
    returned = (time.perf_counter() - t0) * 1e3
    ckpt_lib.wait_for_checkpoints()
    return path, returned, (time.perf_counter() - t0) * 1e3


def phase_checkpoint(smi, device=None, merged=None):
    """The production stage-2 model from the YAML config (config/defaults/
    config_cf_beatdnd.yaml through load_config and from_cfg), bf16: saved
    without its trunk, in the foreground and in the background, loaded into
    a fresh model of the same seed whose other weights were zeroed (every
    tensor bit-equal, the trunk its own), then served from the file through
    build_service (the DDIM-50 overrides, TEST.BATCH_SIZE requests, one
    micro-batch).  Then resume: fp32 batch CKPT_RESUME_BATCH stage 2 with
    dropout 0.1, the generator on the card, N + save + load + M steps
    against N + M straight steps."""
    merged = merged or load_config(os.path.join(
        DEFAULTS_DIR, "config_cf_beatdnd.yaml"))
    cfg = from_cfg(merged)
    seed = cfg["serve"]["seed"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as tmp:
        model = Convofusion(cfg, dtype="bfloat16", device=device, seed=seed)
        dev = model.device
        on_card = dev.type == "cuda"
        path, save_ms, _ = _save_timed(tmp, 1, model)
        size = os.path.getsize(path)
        bg_path, bg_return_ms, bg_ms = _save_timed(os.path.join(tmp, "bg"),
                                                   1, model, background=True)
        same_file = all(torch.equal(v, w) for v, w in zip(
            torch.load(path, weights_only=True)["state_dict"].values(),
            torch.load(bg_path, weights_only=True)["state_dict"].values()))
        trunk_keys = [k for k in torch.load(path, weights_only=True)[
            "state_dict"] if "text_model" in k]
        fresh = Convofusion(cfg, dtype="bfloat16", device=device, seed=seed)
        with torch.no_grad():
            for n, p in fresh.named_parameters():
                if not n.startswith(ckpt_lib.TRUNK):
                    p.zero_()
        live = {k: v.clone() for k, v in fresh.state_dict().items()
                if k.startswith(ckpt_lib.TRUNK)}
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_lib.load_checkpoint(path, fresh)
        if on_card:
            torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        differ = _bit_equal(fresh, model, skip=ckpt_lib.TRUNK)
        trunk_moved = [k for k, v in fresh.state_dict().items()
                       if k in live and not torch.equal(v, live[k])]
        n_tensors = len(model.state_dict())
        log(f"# checkpoint: production stage 2 from the YAML config, bf16, "
            f"{n_tensors} tensors: saved without the trunk in "
            f"{save_ms:.1f} ms, {size / 2**20:.1f} MiB ({len(trunk_keys)} "
            f"trunk keys in the file); in the background the call returned "
            f"in {bg_return_ms:.1f} ms and the write ended at {bg_ms:.1f} ms "
            f"(same tensors: {same_file}); loaded in {load_ms:.1f} ms into a "
            f"fresh model with its other weights zeroed: {len(differ)} "
            f"tensors differ, the live trunk moved in {len(trunk_moved)}")
        if differ or trunk_moved or trunk_keys or not same_file:
            raise RuntimeError(f"checkpoint round trip: differ {differ[:3]}, "
                               f"trunk moved {trunk_moved[:3]}, trunk keys "
                               f"{trunk_keys[:3]}, same file {same_file}")
        del fresh

        # served from the file: one micro-batch of TEST.BATCH_SIZE
        served_cfg = OmegaConf.merge(merged,
                                     OmegaConf.from_dotlist(DDIM_OVERRIDES))
        svc = build_service(served_cfg, dtype="bfloat16", device=device,
                            checkpoint=path)
        try:
            served_differ = _bit_equal(svc.model, model,
                                       skip=ckpt_lib.TRUNK)
            before = COUNTS["guided_step.launches"]
            t0 = time.perf_counter()
            motions, _ = _submit_from_clients(
                svc, _serve_requests(svc.batch_size, 91), SERVE_CLIENTS)
            wall = time.perf_counter() - t0
            _check_served(motions, "checkpoint serve")
            launches = COUNTS["guided_step.launches"] - before
            st = svc.stats()
        finally:
            svc.close()
        log(f"# checkpoint: build_service(config + {DDIM_OVERRIDES}, "
            f"checkpoint=...) on {smi}: {len(served_differ)} tensors differ "
            f"from the saved model; {st['requests']} requests in "
            f"{st['batches']} micro-batch(es), {wall * 1e3:.1f} ms, WEG "
            f"{svc.weg}, {launches} kernel launches")
        if served_differ or st["batches"] != 1 or (
                on_card and launches != STEPS):
            raise RuntimeError(f"checkpoint serve: {len(served_differ)} "
                               f"tensors differ, {st['batches']} batches, "
                               f"{launches} launches")
        del model, svc
        resume_check(cfg, seed, device, tmp)


def resume_check(cfg, seed, device, tmp):
    """fp32 stage 2, dropout 0.1 everywhere, batch CKPT_RESUME_BATCH:
    N steps, a save with the trainer and the generator, a load into a fresh
    model, trainer and generator, M more steps, against N + M straight
    steps from the same seed.  On the card the losses agree to 1e-6
    relative, not bit for bit: the embedding and gather backwards add
    with atomics, so two runs of one step may sum in other orders (at the
    CPU the test suite holds them bit-equal)."""
    n, m = CKPT_RESUME_STEPS
    raw = synthetic_raw_batch(93, CKPT_RESUME_BATCH,
                              mel_frames=cfg["mel_frames"])

    def fresh():
        model = Convofusion(cfg, dtype="float32", device=device, seed=seed)
        gen = torch.Generator(device=model.device)
        return model, Trainer(model), gen

    model, trainer, gen = fresh()
    batch = train_batch(model, raw)
    straight = trainer.fit_steps([batch] * (n + m), gen.manual_seed(94),
                                 log_every=1)
    del model, trainer
    model, trainer, gen = fresh()
    first = trainer.fit_steps([batch] * n, gen.manual_seed(94), log_every=1)
    t0 = time.perf_counter()
    path = ckpt_lib.save_checkpoint(os.path.join(tmp, "resume"), n, model,
                                    trainer, gen)
    save_ms = (time.perf_counter() - t0) * 1e3
    del model, trainer
    model, trainer, gen = fresh()
    t0 = time.perf_counter()
    ckpt_lib.load_checkpoint(path, model, trainer, gen)
    load_ms = (time.perf_counter() - t0) * 1e3
    resumed = first + trainer.fit_steps([batch] * m, gen, log_every=1)
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    log(f"# checkpoint: resume, fp32 stage 2 batch {CKPT_RESUME_BATCH}, "
        f"dropout 0.1: {n} steps + save ({save_ms:.1f} ms, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB with the trainer) + load "
        f"({load_ms:.1f} ms) + {m} steps {[round(x, 7) for x in resumed]} "
        f"against {n + m} straight {[round(x, 7) for x in straight]}: "
        f"relative gap {gap:.3g} (tolerance {CKPT_RESUME_RTOL})")
    if not (np.isfinite(resumed).all() and gap <= CKPT_RESUME_RTOL):
        raise RuntimeError(f"resume: losses {resumed} against {straight}")


def _cli_argv(tmp, roots, name, overrides, cfg="config_cf_beatdnd.yaml"):
    """A CLI's argv: ``cfg`` (config_cf_beatdnd.yaml by default), an assets
    file (merged last) pointing the dataset roots and the output folders
    into ``tmp``, and dotlist overrides."""
    assets = OmegaConf.load(os.path.join(DEFAULTS_DIR, "assets.yaml"))
    assets.DATASET.BEATDND.ROOT = list(roots)
    assets.DATASET.BEATDND.SPLIT_ROOT = list(roots)
    assets.FOLDER = os.path.join(tmp, "experiments")
    assets.TEST = {"FOLDER": os.path.join(tmp, "results")}
    path = os.path.join(tmp, f"assets_{name}.yaml")
    OmegaConf.save(assets, path)
    return ["--cfg", os.path.join(DEFAULTS_DIR, cfg),
            "--cfg_assets", path, f"NAME={name}", *overrides]


def _result_files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


@contextlib.contextmanager
def launches_per_sample(calls):
    """While open, the step-kernel launches of every Convofusion.sample
    call are appended to ``calls``."""
    original = Convofusion.sample

    def counted(self, *args, **kwargs):
        before = COUNTS["guided_step.launches"]
        out = original(self, *args, **kwargs)
        calls.append(COUNTS["guided_step.launches"] - before)
        return out

    Convofusion.sample = counted
    try:
        yield calls
    finally:
        Convofusion.sample = original


@contextlib.contextmanager
def asset_root(path):
    """CONVOFUSION_TPU_ASSETS set to ``path`` while open."""
    saved = os.environ.get("CONVOFUSION_TPU_ASSETS")
    os.environ["CONVOFUSION_TPU_ASSETS"] = path
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CONVOFUSION_TPU_ASSETS"]
        else:
            os.environ["CONVOFUSION_TPU_ASSETS"] = saved


def phase_test_cli(smi, device=None):
    """The test CLI (cli/test.main) on real-format inputs: BEAT/DnD fixture
    trees, a synthesized 32k t5-geometry spiece.model in the asset drop,
    config_cf_beatdnd.yaml with the DDIM-50 overrides, bf16 (TPU.
    COMPUTE_DTYPE), SAVE_PREDICTIONS and the config's 'semantic' WEG, the
    weights a checkpoint of a seeded model.  Then the same CLI in fp32 at
    DDIM-10 on one batch of 4 on the card and on the CPU, and the batch mel
    on the card against the host's.  Returns the timed run's launches."""
    dev_arg = ["--device", device] if device else []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli") as tmp, \
            asset_root(os.path.join(tmp, "assets")):
        t0 = time.perf_counter()
        write_synthetic_spiece(os.path.join(tmp, "assets", "t5-base",
                                            "spiece.model"))
        spiece_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        roots = make_fixture_pair(os.path.join(tmp, "data"),
                                  n_files=CLI_BEAT_FILES)
        fixture_s = time.perf_counter() - t0
        argv = _cli_argv(tmp, roots, "cli",
                         DDIM_OVERRIDES + ["TEST.SAVE_PREDICTIONS=true"])
        merged = parse_args("test", argv)
        seed = int(merged.SEED_VALUE)
        model = Convofusion(from_cfg(merged), dtype="bfloat16",
                            device=device, seed=seed)
        tokenizer = type(model.tokenizer).__name__
        t0 = time.perf_counter()
        tb = model.tokenize(["hello there friend this is a story"] * 32)
        tok_ms = (time.perf_counter() - t0) * 1e3
        log(f"# test_cli: spiece.model synthesized in {spiece_s:.2f} s; the "
            f"model's tokenizer: {tokenizer} (vocab "
            f"{model.tokenizer.vocab_size}, {tok_ms:.1f} ms for 32 texts, "
            f"ids up to {int(tb.input_ids.max())}); fixture trees in "
            f"{fixture_s:.2f} s")
        if not isinstance(model.tokenizer, SentencePieceTokenizer):
            raise RuntimeError(f"the model picked {tokenizer}, not the "
                               f"SentencePiece tokenizer")
        ckpt = ckpt_lib.save_checkpoint(os.path.join(tmp, "ckpt"), 0, model)
        on_card = model.device.type == "cuda"
        del model
        mel_before = dict(COUNTS)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        calls = []
        with launches_per_sample(calls):
            COUNTS["guided_step.launches"] = 0
            t0 = time.perf_counter()
            run = cli_test.main(argv + [f"TEST.CHECKPOINTS={ckpt}"]
                                + dev_arg)
            wall = time.perf_counter() - t0
            launches = COUNTS["guided_step.launches"]
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        mels = {k: COUNTS[f"melspec.{k}"]
                - mel_before.get(f"melspec.{k}", 0)
                for k in ("native", "numpy")}
        files = _result_files(run.out_dir)
        dirs = {os.path.dirname(f) for f in files if f.endswith("pred.npy")}
        att = [f for f in files if "/att_" in f]
        log(f"# test_cli: bf16 DDIM-{STEPS} semantic WEG on {smi}: "
            f"{sum(run.batch_sizes)} test items in batches "
            f"{run.batch_sizes}, {wall:.1f} s in all; datasets built in "
            f"{run.build_s:.2f} s, mels {mels} ({native.status()}); per "
            f"batch: loader {_ms(run.loader_ms)} ms, tokenize "
            f"{_ms(run.tokenize_ms)} ms, sample {_ms(run.sample_ms)} ms "
            f"({[round(b / t * 1e3, 2) for b, t in zip(run.batch_sizes, run.sample_ms)]}"
            f" clips/s), step-kernel launches {calls}; {len(dirs)} result "
            f"directories, {len(att)} attention-map files; peak memory "
            f"{peak / 2**30:.2f} GiB")
        if len(dirs) != sum(run.batch_sizes) or len(run.batch_sizes) != 1 \
                or len(att) != len(dirs) * 5 * STEPS:
            raise RuntimeError(f"test_cli: {len(dirs)} result directories, "
                               f"{len(att)} attention maps for batches "
                               f"{run.batch_sizes}")
        if on_card and (calls != [STEPS] * len(run.batch_sizes)
                        or mels["numpy"] or not mels["native"]):
            raise RuntimeError(f"test_cli: launches {calls} a batch, mel "
                               f"paths {mels} ({native.status()})")
        if not all(np.isfinite(lat).all() for lat in run.latents):
            raise RuntimeError("test_cli: non-finite latents")
        cli_parity(tmp, ckpt, dev_arg)
        batch_mel_check(roots[0], on_card)
    return launches


def _ms(values):
    return [round(v, 1) for v in values]


def cli_parity(tmp, ckpt, dev_arg):
    """The CLI in fp32 at DDIM-10 on one batch of 4 BEAT items, on the
    device and on the CPU, from one checkpoint and the CLI's host-drawn
    noise, semantic WEG with the refinement capped at CLI_PARITY_REFINE:
    the same result files, byte-equal semantic CSVs and texts, motion
    (pred.npy) within 1e-3 and latents within 2e-3."""
    roots = make_fixture_pair(os.path.join(tmp, "parity"), n_files=1)
    over = ["model.scheduler.variant=ddim",
            f"model.scheduler.num_inference_timesteps={CLI_PARITY_STEPS}",
            "TPU.COMPUTE_DTYPE=float32", "DATASET.BEATDND.SELECT=beat",
            f"TEST.BATCH_SIZE={CLI_PARITY_BATCH}",
            f"TEST.CHECKPOINTS={ckpt}",
            f"model.weg_parameters.max_refinement_steps={CLI_PARITY_REFINE}"]
    runs = {}
    for side, extra in (("card", dev_arg), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        runs[side] = (cli_test.main(_cli_argv(tmp, roots, f"parity_{side}",
                                              over) + extra),
                      time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = runs["card"], runs["cpu"]
    files = _result_files(card.out_dir)
    same_files = files == _result_files(cpu.out_dir)
    byte_equal, motion_gap = [], 0.0
    for rel in files if same_files else []:
        a = os.path.join(card.out_dir, rel)
        b = os.path.join(cpu.out_dir, rel)
        if rel.endswith((".csv", ".txt")):
            with open(a, "rb") as f, open(b, "rb") as g:
                byte_equal.append(f.read() == g.read())
        elif rel.endswith("pred.npy"):
            motion_gap = max(motion_gap, float(np.abs(
                np.load(a) - np.load(b)).max()))
    latent_gap = max(float(np.abs(x - y).max())
                     for x, y in zip(card.latents, cpu.latents))
    n_csv = sum(f.endswith(".csv") for f in files)
    log(f"# test_cli: fp32 DDIM-{CLI_PARITY_STEPS} batch "
        f"{card.batch_sizes} card ({card_s:.1f} s) vs CPU ({cpu_s:.1f} s): "
        f"{len(files)} files each, same names {same_files}, "
        f"{sum(byte_equal)}/{len(byte_equal)} text and CSV files "
        f"byte-equal ({n_csv} semantic CSVs), |motion| gap "
        f"{motion_gap:.3g} (tol {CLI_MOTION_ATOL}), |latents| gap "
        f"{latent_gap:.3g} (tol {CLI_LATENT_ATOL})")
    if not (same_files and all(byte_equal) and n_csv
            and card.batch_sizes == [CLI_PARITY_BATCH]
            and motion_gap <= CLI_MOTION_ATOL
            and latent_gap <= CLI_LATENT_ATOL):
        raise RuntimeError("test_cli: the card's run differs from the CPU's")


def batch_mel_check(beat_root, on_card):
    """melspectrogram_batch on the device against the host
    melspectrogram, over the fixture's 5.12 s BEAT windows."""
    sr, win = 16000, int(128 / 25 * 16000)
    clips = []
    for path in sorted(glob.glob(os.path.join(beat_root, "*", "*.wav"))):
        y, _ = audio.load_wav(path, sr)
        clips += [audio.normalize(y[i * win:(i + 1) * win])
                  for i in range(len(y) // win)]
    y = np.stack(clips)
    t0 = time.perf_counter()
    host = np.stack([audio.melspectrogram(c) for c in clips])
    host_ms = (time.perf_counter() - t0) * 1e3
    dev = "cuda" if on_card else "cpu"
    yt = torch.from_numpy(y).to(dev)
    for _ in range(3):
        power = audio.melspectrogram_batch(yt)
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        power = audio.melspectrogram_batch(yt)
        db = audio.power_to_db_batch(power)
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end)
    else:
        db = audio.power_to_db_batch(power)
        dev_ms = float("nan")
    power, db = power.cpu().numpy(), db.cpu().numpy()
    power_gap = float(np.abs(power - host).max() / host.max())
    db_gap = float(max(np.abs(db[i] - audio.power_to_db(host[i])).max()
                       for i in range(len(clips))))
    log(f"# test_cli: batch mel of {len(clips)} clips of {win} samples on "
        f"{dev}: {dev_ms:.3f} ms (power + dB, CUDA events) against "
        f"{host_ms:.1f} ms on the host ({native.status()}); power gap "
        f"{power_gap:.3g} of the max (tol {MEL_POWER_RTOL}), dB gap "
        f"{db_gap:.3g} (tol {MEL_DB_ATOL})")
    if not (power_gap <= MEL_POWER_RTOL and db_gap <= MEL_DB_ATOL):
        raise RuntimeError("test_cli: the batch mel disagrees with the host")


@contextlib.contextmanager
def sync_checked_step(index, found):
    """While open, Trainer step ``index`` (counted from 0 over every
    Trainer) runs with the CUDA sync checker on, from its compute_grads to
    the end of its apply_grads; each synchronising operation of the main
    thread in it is appended to ``found``.  The prefetch thread's work
    (cache-miss encodes copied to the host) is not the step's and is not
    counted."""
    compute, apply = Trainer.compute_grads, Trainer.apply_grads
    state = {"step": 0, "ctx": None}
    main = threading.current_thread()

    def show(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if threading.current_thread() is main and \
                "called a synchronizing CUDA operation" in text:
            found.append(text)

    def compute_grads(self, *args, **kwargs):
        if state["step"] == index:
            state["ctx"] = warnings.catch_warnings()
            state["ctx"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
        return compute(self, *args, **kwargs)

    def apply_grads(self):
        try:
            return apply(self)
        finally:
            if state["ctx"] is not None:
                torch.cuda.set_sync_debug_mode(0)
                state["ctx"].__exit__(None, None, None)
                state["ctx"] = None
            state["step"] += 1

    Trainer.compute_grads, Trainer.apply_grads = compute_grads, apply_grads
    try:
        yield found
    finally:
        Trainer.compute_grads, Trainer.apply_grads = compute, apply


@contextlib.contextmanager
def dropout_free_training():
    """While open, the train CLI's model has every dropout rate at 0 (the
    mel MLP's 0.1 is not a config knob): card and CPU draw their masks
    from generators of their own, so only a dropout-free run compares."""
    build = cli_train.build_model

    def build_model(cfg, dtype, device):
        model = build(cfg, dtype, device)
        for m in model.modules():
            if isinstance(m, (layers.Dropout, torch.nn.Dropout)):
                m.p = 0.0
        return model

    cli_train.build_model = build_model
    try:
        yield
    finally:
        cli_train.build_model = build


def _metric_rows(exp_dir, what):
    """metrics.jsonl's rows; every value finite, total/train and
    total/val in each."""
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        bad = [k for k, v in row.items() if not np.isfinite(v)]
        if bad or not {"total/train", "total/val"} <= set(row):
            raise RuntimeError(f"train_cli {what}: epoch {row['step']}: "
                               f"non-finite {bad}, keys {sorted(row)}")
    return rows


def _cache_deltas(stats, name):
    """Each epoch's hits and misses of a cache (the stats are running
    totals)."""
    out, hits, misses = [], 0, 0
    for e in stats.epochs:
        out.append((e[f"{name}_hits"] - hits, e[f"{name}_misses"] - misses))
        hits, misses = e[f"{name}_hits"], e[f"{name}_misses"]
    return out


def phase_train_cli(smi, device=None):
    """The training CLI on fixture trees, both stages at the production
    configs' full width, then the rollout CLI, eval and unguided
    sampling."""
    dev_arg = ["--device", device] if device else []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train") as tmp, \
            asset_root(os.path.join(tmp, "assets")):
        t0 = time.perf_counter()
        write_synthetic_spiece(os.path.join(tmp, "assets", "t5-base",
                                            "spiece.model"))
        roots = make_fixture_pair(os.path.join(tmp, "data"),
                                  n_files=TRAIN_CLI_FILES)
        log(f"# train_cli: spiece.model and fixture trees "
            f"({TRAIN_CLI_FILES} BEAT files a speaker) in "
            f"{time.perf_counter() - t0:.2f} s")
        common = [f"TRAIN.END_EPOCH={TRAIN_CLI_EPOCHS}",
                  "LOGGER.VAL_EVERY_STEPS=1", "LOGGER.SACE_CHECKPOINT_EPOCH=1",
                  "TPU.COMPUTE_DTYPE=bfloat16"]
        exp = os.path.join(tmp, "experiments", "convofusion")
        before = COUNTS["guided_step.launches"]

        # stage 1
        t0 = time.perf_counter()
        s1 = cli_train.main(_cli_argv(tmp, roots, "vae", common,
                                      cfg="config_vae_beatdnd.yaml")
                            + dev_arg)
        s1_wall = time.perf_counter() - t0
        b1 = int(s1.cfg["train"]["batch_size"])
        st1 = s1.train_stats
        rows1 = _metric_rows(os.path.join(exp, "vae"), "stage 1")
        log(f"# train_cli: stage 1 (config_vae_beatdnd.yaml), bf16, batch "
            f"{b1} of {st1.train_items} train items, {TRAIN_CLI_EPOCHS} "
            f"epochs with validation and a background checkpoint each, on "
            f"{smi}: {s1_wall:.1f} s in all, data modules {st1.build_s:.2f}"
            f" s, steps an epoch {[e['steps'] for e in st1.epochs]}, "
            f"total/train {[round(r['total/train'], 4) for r in rows1]}, "
            f"total/val {[round(r['total/val'], 4) for r in rows1]}")
        if st1.train_items < b1 or [e["steps"] for e in st1.epochs] != \
                [st1.train_items // b1] * TRAIN_CLI_EPOCHS:
            raise RuntimeError(f"train_cli stage 1: {st1.train_items} items "
                               f"for batch {b1}: {st1.epochs}")
        vae_ckpt = ckpt_lib.latest_checkpoint(os.path.join(exp, "vae",
                                                           "checkpoints"))
        del s1

        # stage 2 from the stage-1 file, both caches on, prefetch 2
        over2 = common + [f"TRAIN.PRETRAINED_VAE={vae_ckpt}",
                          "TPU.CACHE_TEXT_TRUNK=true",
                          "TPU.CACHE_VAE_POSTERIOR=true", "TPU.PREFETCH=2"]
        on_card = device != "cpu"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        found = []
        t0 = time.perf_counter()
        with sync_checked_step(2, found) if on_card \
                else contextlib.nullcontext():
            s2 = cli_train.main(_cli_argv(tmp, roots, "cf", over2) + dev_arg)
        s2_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        st2 = s2.train_stats
        b2 = int(s2.cfg["train"]["batch_size"])
        rows2 = _metric_rows(os.path.join(exp, "cf"), "stage 2")
        steady = st2.epochs[1:]
        n_steps = sum(e["steps"] for e in steady)
        step_s = sum(e["seconds"] for e in steady) / n_steps
        # without the wait for each epoch's first batch
        inner_s = sum(e["seconds"] - e["first_batch_s"]
                      for e in steady) / n_steps
        # where a steady step's host time goes: the prefetch thread's loader
        # and prepare a batch, the step loop's wait for a batch after the
        # first of its epoch
        loader_ms = sum(e["loader_s"] for e in steady) / n_steps * 1e3
        prepare_ms = sum(e["prepare_s"] for e in steady) / n_steps * 1e3
        wait_ms = sum(e["wait_s"] for e in steady) / sum(
            e["steps"] - 1 for e in steady) * 1e3
        trunk = _cache_deltas(st2, "trunk")
        post = _cache_deltas(st2, "posterior")
        phase12 = PHASE_RESULTS.get("train", {}).get("stage2_cached")
        beside = (f"phase 12's Trainer step with the cached layout "
                  f"{phase12['ms']:.2f} ms" if phase12
                  else "phase 12 did not run")
        log(f"# train_cli: stage 2 (config_cf_beatdnd.yaml, the stage-1 "
            f"file transplanted), bf16, batch {b2} of {st2.train_items} "
            f"train items, trunk and posterior caches, prefetch 2, on {smi}:"
            f" {s2_wall:.1f} s in all, data modules {st2.build_s:.2f} s; "
            f"steady epochs {step_s * 1e3:.1f} ms a step, "
            f"{b2 / step_s:.1f} clips/s, {inner_s * 1e3:.1f} ms a step "
            f"after each epoch's first batch ({beside}); on the prefetch "
            f"thread a batch takes {loader_ms:.1f} ms in the loader and "
            f"{prepare_ms:.1f} ms in prepare, the step loop waits "
            f"{wait_ms:.1f} ms a step for a batch after the first; seconds "
            f"an epoch "
            f"{[round(e['seconds'], 3) for e in st2.epochs]}, of them until "
            f"the first batch "
            f"{[round(e['first_batch_s'], 3) for e in st2.epochs]}, steps "
            f"{[e['steps'] for e in st2.epochs]}; trunk cache (hits, misses)"
            f" an epoch {trunk}, posterior cache {post}; peak memory "
            f"{peak / 2**30:.2f} GiB; total/train "
            f"{[round(r['total/train'], 4) for r in rows2]}, total/val "
            f"{[round(r['total/val'], 4) for r in rows2]}")
        if any(miss for _, miss in trunk[1:]):
            raise RuntimeError(f"train_cli: trunk cache misses after the "
                               f"first epoch: {trunk}")
        if on_card:
            for msg in found[:5]:
                log(f"# train_cli: host wait: {msg[:300]}")
            if found:
                raise RuntimeError(f"train_cli: {len(found)} host waits in "
                                   f"a stage-2 step")
            log("# train_cli: no wait for the card inside stage-2 step 2 "
                "(CUDA sync checker)")

        # one more epoch through TRAIN.RESUME, with the batches prepared
        # inline (TPU.PREFETCH=0): the same work without the thread
        latest = ckpt_lib.latest_checkpoint(os.path.join(exp, "cf",
                                                         "checkpoints"))
        over4 = [o for o in over2 if not o.startswith(
            ("TRAIN.END_EPOCH", "TPU.PREFETCH"))] + ["TPU.PREFETCH=0"]
        t0 = time.perf_counter()
        s3 = cli_train.main(_cli_argv(
            tmp, roots, "cf", over4 + [f"TRAIN.END_EPOCH="
                                       f"{TRAIN_CLI_EPOCHS + 1}",
                                       "TRAIN.RESUME=true"]) + dev_arg)
        st3 = s3.train_stats
        e3 = st3.epochs[-1]
        log(f"# train_cli: resumed from {os.path.basename(latest)} at epoch "
            f"{st3.start_epoch}: {time.perf_counter() - t0:.1f} s, epochs "
            f"{[e['epoch'] for e in st3.epochs]}; inline (prefetch 0) "
            f"{e3['seconds'] / e3['steps'] * 1e3:.1f} ms a step, of it "
            f"{e3['loader_s'] / e3['steps'] * 1e3:.1f} ms in the loader and "
            f"{e3['prepare_s'] / e3['steps'] * 1e3:.1f} ms in prepare, "
            f"against {step_s * 1e3:.1f} ms with prefetch 2")
        if os.path.basename(latest) != f"epoch={TRAIN_CLI_EPOCHS - 1}.ckpt" \
                or st3.start_epoch != TRAIN_CLI_EPOCHS or \
                [e["epoch"] for e in st3.epochs] != [TRAIN_CLI_EPOCHS]:
            raise RuntimeError(f"train_cli: resume from {latest} started at "
                               f"{st3.start_epoch}: {st3.epochs}")
        _metric_rows(os.path.join(exp, "cf"), "resume")
        train_launches = COUNTS["guided_step.launches"] - before
        if train_launches:
            raise RuntimeError(f"train_cli: training launched the step "
                               f"kernel {train_launches} times")
        del s2, s3

        train_cli_parity(tmp, vae_ckpt, dev_arg)
        ckpt2 = ckpt_lib.latest_checkpoint(os.path.join(exp, "cf",
                                                        "checkpoints"))
        out_dir = phase_unbounded_cli(smi, tmp, ckpt2, dev_arg)
        eval_cli(out_dir, dev_arg)
    unguided_parity(device)
    log(f"# train_cli: the phase's parts took {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def recorded_updates(record):
    """While open, each Trainer.apply_grads first appends to ``record``
    the step's learning rate and its clipped fp32 gradients on the host,
    by the trainer's parameter names; the first also stores the masters
    as they were before it ('w0')."""
    apply = Trainer.apply_grads

    def apply_grads(self):
        grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                 for p, m in zip(self.params, self.masters)]
        if "w0" not in record:
            record["w0"] = {n: m.detach().to("cpu", copy=True)
                            for n, m in zip(self.names, self.masters)}
        record.setdefault("lr", []).append(
            float(self.optimizer.schedule(self.state.count)))
        record.setdefault("grads", []).append(
            {n: g.detach().to("cpu", copy=True)
             for n, g in zip(self.names, adamw.clip_by_global_norm(
                 grads, self.optimizer.grad_clip))})
        return apply(self)

    Trainer.apply_grads = apply_grads
    try:
        yield record
    finally:
        Trainer.apply_grads = apply


def adamw_replay(opt, w0, grads, lrs):
    """The weight after AdamW steps over one element's gradients, in
    float64 (``adamw.adamw_updates``' formula)."""
    w, m, v = float(w0), 0.0, 0.0
    for t, (g, lr) in enumerate(zip(grads, lrs), 1):
        m = opt.b1 * m + (1 - opt.b1) * g
        v = opt.b2 * v + (1 - opt.b2) * g * g
        u = (m / (1 - opt.b1 ** t)) / (math.sqrt(v / (1 - opt.b2 ** t))
                                       + opt.eps)
        w -= lr * (u + opt.weight_decay * w)
    return w


def train_cli_parity(tmp, vae_ckpt, dev_arg):
    """The stage-2 CLI on the card and on the CPU: production geometry,
    fp32, dropout 0, batch 4, TRAIN_CLI_PARITY_EPOCHS epochs from the same
    stage-1 file, both
    caches on, no validation.  As phase 11 argues for the Trainer, each
    epoch's total/train is held to 1e-4 relative and every step's
    gradients to 1e-5 + 1e-3 max|g| of their tensor.  Every weight of the
    two final checkpoints must lie within 1e-5 + 1e-3 max|w| of its tensor,
    except where AdamW explains the gap: its m / sqrt(v) moves an element
    by about lr a step whatever the gradient's size, so an element whose
    gradient sits at the rounding noise of its sums can step in opposite
    directions on the two devices.  Such an element (at most
    TRAIN_CLI_REPLAY_MAX) must equal, on each device, a float64 AdamW
    replay of that device's recorded gradients within 1e-6; its gradients
    are printed."""
    roots = make_fixture_pair(os.path.join(tmp, "parity"), n_files=1)
    over = [f"TRAIN.END_EPOCH={TRAIN_CLI_PARITY_EPOCHS}",
            f"TRAIN.BATCH_SIZE={TRAIN_CLI_PARITY_BATCH}",
            "TPU.COMPUTE_DTYPE=float32", f"TRAIN.PRETRAINED_VAE={vae_ckpt}",
            "LOGGER.VAL_EVERY_STEPS=0"]
    exp = os.path.join(tmp, "experiments", "convofusion")
    out = {}
    with dropout_free_training():
        for side, extra in (("card", dev_arg), ("cpu", ["--device", "cpu"])):
            t0 = time.perf_counter()
            with recorded_updates({}) as record:
                model = cli_train.main(_cli_argv(tmp, roots, f"p_{side}",
                                                 over) + extra)
            with open(os.path.join(exp, f"p_{side}", "metrics.jsonl")) as f:
                losses = [json.loads(line)["total/train"] for line in f]
            path = ckpt_lib.latest_checkpoint(os.path.join(
                exp, f"p_{side}", "checkpoints"))
            out[side] = dict(
                losses=losses, record=record,
                weights=torch.load(path, weights_only=True)["state_dict"],
                seconds=time.perf_counter() - t0,
                steps=[e["steps"] for e in model.train_stats.epochs])
            opt = make_optimizer(model.cfg)
            del model
    card, cpu = out["card"], out["cpu"]
    w_card, w_cpu = card["weights"], cpu["weights"]
    d_loss = max(abs(a - c) / abs(c)
                 for a, c in zip(card["losses"], cpu["losses"]))
    n_steps = sum(card["steps"])

    # every step's gradients, card against CPU
    g_worst, g_name = 0.0, ""
    for step, (gc, gp) in enumerate(zip(card["record"]["grads"],
                                        cpu["record"]["grads"])):
        for name, want in gp.items():
            tol = TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(want.abs().max())
            r = float((gc[name] - want).abs().max()) / tol
            if r > g_worst:
                g_worst, g_name = r, f"{name} (step {step + 1})"

    # the weights; an element beyond the bound must be AdamW's doing
    port_name = {ref: port for ref, port in
                 ckpt_lib._from_reference_names({k: k for k in w_cpu}).items()}
    beyond, n_elems = [], 0
    for name, want in w_cpu.items():
        diff = (w_card[name] - want).abs()
        n_elems += diff.numel()
        tol = TRAIN_CLI_WEIGHT_ATOL + TRAIN_CLI_WEIGHT_RTOL * float(
            want.abs().max())
        for idx in torch.nonzero(diff > tol).tolist():
            beyond.append((float(diff[tuple(idx)]), name, tuple(idx), tol))
    beyond.sort(reverse=True)
    unexplained, shown = [], []
    for gap, name, idx, tol in beyond[:TRAIN_CLI_REPLAY_MAX]:
        pname = port_name[name]
        if pname not in cpu["record"]["w0"]:
            unexplained.append(f"{name}{list(idx)}: not trained")
            continue
        rows = []
        for side, weights in ((card, w_card), (cpu, w_cpu)):
            rec = side["record"]
            gs = [float(g[pname][idx]) for g in rec["grads"]]
            want = adamw_replay(opt, rec["w0"][pname][idx], gs, rec["lr"])
            got = float(weights[name][idx])
            scale = max(float(g[pname].abs().max()) for g in rec["grads"])
            rows.append((gs, got, want, scale))
            if not abs(got - want) <= TRAIN_CLI_REPLAY_ATOL:
                unexplained.append(f"{name}{list(idx)}: {got} against "
                                   f"AdamW's {want}")
        if len(shown) < 3:
            (g_c, got_c, _, scale), (g_p, got_p, _, _) = rows
            shown.append(
                f"{name}{list(idx)}: gap {gap:.3g} (tol {tol:.3g}); "
                f"gradients card {[f'{g:.3g}' for g in g_c]}, CPU "
                f"{[f'{g:.3g}' for g in g_p]} (the tensor's max|g| "
                f"{scale:.3g}); weights {got_c:.6g} / {got_p:.6g}, each "
                f"AdamW's replay of its own gradients")
    log(f"# train_cli: fp32 stage 2 through the CLI, batch "
        f"{TRAIN_CLI_PARITY_BATCH}, steps an epoch {card['steps']}, card "
        f"({card['seconds']:.1f} s) vs CPU ({cpu['seconds']:.1f} s): "
        f"total/train {[round(x, 6) for x in card['losses']]} / "
        f"{[round(x, 6) for x in cpu['losses']]}, relative gap {d_loss:.3g} "
        f"(tol {TRAIN_CLI_LOSS_RTOL}); {n_steps} steps' gradients, the worst "
        f"at {g_worst:.3g} of 1e-5 + 1e-3 max|g| ({g_name}); {len(w_cpu)} "
        f"weights, {len(beyond)} of {n_elems} elements beyond 1e-5 + 1e-3 "
        f"max|w|, each AdamW's replay of its device's gradients within "
        f"{TRAIN_CLI_REPLAY_ATOL}: {not unexplained}")
    for line in shown:
        log(f"#   {line}")
    for line in unexplained[:5]:
        log(f"#   unexplained: {line}")
    if set(w_card) != set(w_cpu) or len(card["losses"]) != \
            TRAIN_CLI_PARITY_EPOCHS or not d_loss <= TRAIN_CLI_LOSS_RTOL \
            or not g_worst <= 1.0 or unexplained \
            or len(beyond) > TRAIN_CLI_REPLAY_MAX \
            or len(card["record"]["grads"]) != n_steps:
        raise RuntimeError("train_cli: the card's CLI run differs from the "
                           "CPU's")


def phase_unbounded_cli(smi, tmp, ckpt, dev_arg):
    """cli/unbounded.main from the stage-2 checkpoint: bf16, DDIM-50, the
    config's WEG type ('semantic') with the refinement capped at
    UNBOUNDED_REFINE iterations, one test batch at MAX_LEN
    UNBOUNDED_MAX_LEN.  Returns the dump directory."""
    roots = make_fixture_pair(os.path.join(tmp, "long"),
                              n_files=UNBOUNDED_FILES)
    over = DDIM_OVERRIDES + [
        f"DATASET.SAMPLER.MAX_LEN={UNBOUNDED_MAX_LEN}",
        f"DATASET.SAMPLER.MIN_LEN={UNBOUNDED_MAX_LEN}",
        f"TEST.CHECKPOINTS={ckpt}"]
    n_windows = 2 * (UNBOUNDED_MAX_LEN // 128) - 1
    calls = []
    fixed = cli_unbounded.ROLLOUT_WEG_PARAMETERS
    cli_unbounded.ROLLOUT_WEG_PARAMETERS = dict(
        fixed, max_refinement_steps=UNBOUNDED_REFINE)
    t0 = time.perf_counter()
    try:
        with launches_per_sample(calls):
            run = cli_unbounded.main(_cli_argv(tmp, roots, "long", over)
                                     + dev_arg)
    finally:
        cli_unbounded.ROLLOUT_WEG_PARAMETERS = fixed
    wall = time.perf_counter() - t0
    files = _result_files(run.out_dir)
    dirs = {os.path.dirname(f) for f in files if f.endswith("pred.npy")}
    b = sum(run.batch_sizes)
    log(f"# train_cli: cli/unbounded.main bf16 DDIM-{STEPS} semantic WEG "
        f"(refinement capped at {UNBOUNDED_REFINE}) on "
        f"{smi}: batches {run.batch_sizes} of {n_windows} windows, "
        f"{wall:.1f} s in all (data modules {run.build_s:.2f} s), rollout "
        f"{[round(x, 2) for x in run.seconds]} s, "
        f"{b * n_windows / sum(run.seconds):.2f} windows/s; step-kernel "
        f"launches a window {calls}; {run.weg_counts}; {len(dirs)} result "
        f"directories, {len(files)} files")
    wc = run.weg_counts
    if len(run.batch_sizes) != 1 or len(dirs) != b * n_windows or \
            wc.refinement_iterations > UNBOUNDED_REFINE * wc.refined_steps:
        raise RuntimeError(f"unbounded: batches {run.batch_sizes}, "
                           f"{len(dirs)} result directories, {wc}")
    if dev_arg != ["--device", "cpu"] and calls != [STEPS] * n_windows:
        raise RuntimeError(f"unbounded: launches a window {calls}")
    for outs in run.windows:
        _check_windows(outs, (b, 128, 189), "unbounded")
    return run.out_dir


def eval_cli(out_dir, dev_arg):
    """eval/run.main over the rollout's dump, dyadic (random-init FID
    features) and monadic, on the device and with --device cpu: every key
    finite, the two within 1e-5 relative.  Only dyadic's FID forward runs
    on the device; monadic is numpy on the host on both sides, so its
    comparison checks the run, not the card."""
    for mode in ("dyadic", "monadic"):
        res = {}
        for side, extra in (("card", dev_arg), ("cpu", ["--device", "cpu"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res[side] = (eval_run.main(["--result_dir", out_dir, "--mode",
                                            mode] + extra),
                             time.perf_counter() - t0)
        (card, s_card), (cpu, s_cpu) = res["card"], res["cpu"]
        bad = [k for k, v in card.items()
               if v is None or not np.isfinite(v)]
        gap = max(abs(card[k] - v) / max(abs(v), 1e-30)
                  for k, v in cpu.items() if k not in bad)
        where = ("the FID forward on the card" if mode == "dyadic"
                 else "host-only: numpy on both sides")
        log(f"# train_cli: eval/run.main --mode {mode} ({where}): with the "
            f"card {s_card:.2f} s, --device cpu {s_cpu:.2f} s; "
            f"{json.dumps(card, default=float)}; largest relative gap to "
            f"the CPU's {gap:.3g} (tol {EVAL_RTOL})")
        if bad or set(card) != set(cpu) or not gap <= EVAL_RTOL:
            raise RuntimeError(f"eval {mode}: non-finite {bad}, keys "
                               f"{sorted(card)} / {sorted(cpu)}, gap {gap}")


def unguided_parity(device=None):
    """sample() with guidance_scale 1.0 (one denoiser call a step on the
    real conditions), fp32 batch 2, DDIM-10 and dpmpp_2m-10, the card
    against the CPU from numpy-made noise: motion within 1e-3, latents
    within 2e-3 (phases 6, 8 and 10's tolerances; without the x37.5
    guidance amplification the gaps are smaller), no step-kernel launch."""
    cfg = copy.deepcopy(PRODUCTION)
    cfg["guidance_scale"] = 1.0
    b, lat = 2, cfg["latent_dim"][1]
    raw = synthetic_raw_batch(81, b, mel_frames=cfg["mel_frames"])
    rng = np.random.default_rng(82)
    init = torch.from_numpy(rng.standard_normal((b, 16, lat)).astype(
        np.float32))
    steps = torch.from_numpy(rng.standard_normal(
        (UNGUIDED_STEPS, b, 16, lat)).astype(np.float32))
    before = COUNTS["guided_step.launches"]
    out = {}
    for side in (device, "cpu"):
        model = Convofusion(cfg, dtype="float32", device=side, seed=0)
        batch, _, _ = prepare_arrays(model, raw)
        for variant in ("ddim", "dpmpp_2m"):
            model.scheduler = dataclasses.replace(model.scheduler,
                                                  variant=variant)
            motion, latents = model.sample(
                batch, num_inference_steps=UNGUIDED_STEPS, init_noise=init,
                step_noise=steps if variant == "ddim" else None)
            out[side, variant] = (motion.float().cpu(), latents.cpu())
        del model
    launches = COUNTS["guided_step.launches"] - before
    for variant in ("ddim", "dpmpp_2m"):
        (m_dev, l_dev), (m_cpu, l_cpu) = out[device, variant], \
            out["cpu", variant]
        for t in (m_dev, m_cpu):
            if t.shape != (b, 128, 189) or not torch.isfinite(t).all():
                raise RuntimeError(f"unguided {variant}: motion misshapen "
                                   f"or not finite")
        dm = float((m_dev - m_cpu).abs().max())
        dl = float((l_dev - l_cpu).abs().max())
        log(f"# train_cli: unguided {variant}-{UNGUIDED_STEPS} fp32 batch {b}"
            f" card vs CPU: max|motion diff| {dm:.3g}, max|latent diff| "
            f"{dl:.3g}; tolerances {PARITY_ATOL}, {DPMPP_LATENT_ATOL}; "
            f"{launches} step-kernel launches")
        if not dm <= PARITY_ATOL or not dl <= DPMPP_LATENT_ATOL:
            raise RuntimeError(f"unguided {variant}: card vs CPU {dm} / {dl}")
    if launches:
        raise RuntimeError(f"unguided sampling launched the step kernel "
                           f"{launches} times")


def _card_cpu_gap(what, dev_out, cpu_out, phase="variants",
                  bounds=(PARITY_ATOL, VARIANT_LATENT_ATOL)):
    """max |motion| and |latent| gaps of two (motion, latents) pairs, held
    to ``bounds`` (phase 4's: motion 1e-3, latents 2e-3)."""
    (m_d, l_d), (m_c, l_c) = dev_out, cpu_out
    for t in (m_d, m_c):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{phase} {what}: motion not finite")
    dm = float((m_d - m_c).abs().max())
    dl = float((l_d - l_c).abs().max())
    log(f"# {phase}: {what}: max|motion diff| {dm:.3g}, max|latent diff| "
        f"{dl:.3g}; tolerances {bounds[0]}, {bounds[1]}")
    if not dm <= bounds[0] or not dl <= bounds[1]:
        raise RuntimeError(f"{phase} {what}: {dm} / {dl} over the bounds")
    return dm, dl


def _fp32_sample(cfg, side, raw, init, steps, state_dict=None):
    """fp32 ``sample()`` on ``side`` from numpy-made noise: (motion,
    latents) on the host and the step kernel's launches."""
    model = Convofusion(cfg, dtype="float32", device=side,
                        seed=0 if state_dict is None else None)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    batch, _, _ = prepare_arrays(model, raw)
    before = COUNTS["guided_step.launches"]
    motion, latents = model.sample(batch, num_inference_steps=len(steps),
                                   init_noise=init, step_noise=steps)
    return ((motion.float().cpu(), latents.cpu()),
            COUNTS["guided_step.launches"] - before)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _kernels_a_step(model, batch, gen, n_steps=2):
    """Device kernels a reverse step, from a profile of ``n_steps`` (0 off
    the card)."""
    if model.device.type != "cuda":
        return 0
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    with torch.inference_mode():
        cond, masks = model.encode_conditions(*(batch[k] for k in keys))
        unc, umasks = model.encode_uncond(batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.diffusion_reverse(cond, masks, unc, umasks,
                                    batch["lsn_ids"].shape[0],
                                    num_inference_steps=n_steps,
                                    generator=gen)
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) // n_steps


def fused_variant(smi, device):
    """The fused five-stream layout at the production width: weights from
    the unfused model through the converter; fp32 batch 4 DDIM-10 on the
    card against the CPU and against the unfused layout on the card; then
    bf16 batch 96 DDIM-50 against the unfused layout, in turns after a
    DDIM-2 warm-up of each."""
    cfg = copy.deepcopy(PRODUCTION)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=STEPS)
    fcfg = copy.deepcopy(cfg)
    fcfg["denoiser"]["fuse_streams"] = True
    b, lat = VARIANT_PARITY_BATCH, cfg["latent_dim"][1]
    raw = synthetic_raw_batch(91, b, mel_frames=cfg["mel_frames"])
    init, steps = _noise(np.random.default_rng(92), VARIANT_PARITY_STEPS,
                         (b, 16, lat))
    unfused = Convofusion(cfg, dtype="float32", device="cpu", seed=0)
    fused_sd = fuse_denoiser_params(unfused.state_dict())
    del unfused
    out, launches = {}, {}
    for name, c, sd, side in (("unfused card", cfg, None, device),
                              ("fused card", fcfg, fused_sd, device),
                              ("fused CPU", fcfg, fused_sd, "cpu")):
        out[name], launches[name] = _fp32_sample(c, side, raw, init, steps,
                                                 sd)
    on_card = torch.device(device).type == "cuda"
    if launches["fused card"] or on_card and launches["unfused card"] != \
            VARIANT_PARITY_STEPS:
        raise RuntimeError(f"variants fused: step-kernel launches {launches}"
                           f", want 0 fused and {VARIANT_PARITY_STEPS} "
                           f"unfused")
    _card_cpu_gap(f"fused fp32 batch {b} DDIM-{VARIANT_PARITY_STEPS} card "
                  f"vs CPU", out["fused card"], out["fused CPU"])
    _card_cpu_gap("fused vs unfused on the card", out["fused card"],
                  out["unfused card"])

    # bf16 batch 96 DDIM-50, in turns
    models = {"unfused": Convofusion(cfg, dtype="bfloat16", device=device,
                                     seed=0)}
    models["fused"] = Convofusion(fcfg, dtype="bfloat16", device=device,
                                  seed=None)
    models["fused"].load_state_dict(fuse_denoiser_params(
        models["unfused"].state_dict()))
    raw = synthetic_raw_batch(93, BATCH, mel_frames=cfg["mel_frames"])
    batch, _, _ = prepare_arrays(models["fused"], raw)
    gen = torch.Generator(device=device).manual_seed(94)
    times = {k: [] for k in models}
    counts = {k: 0 for k in models}
    for turn in range(1 + VARIANT_TURNS):
        for name, model in models.items():
            before = COUNTS["guided_step.launches"]
            t0 = time.perf_counter()
            motion, _ = model.sample(batch, gen,
                                     STEPS if turn else WARMUP_STEPS)
            _sync(device)
            dt = time.perf_counter() - t0
            counts[name] += COUNTS["guided_step.launches"] - before
            if tuple(motion.shape) != (BATCH, 128, 189) or \
                    not torch.isfinite(motion).all():
                raise RuntimeError(f"variants {name}: motion misshapen or "
                                   f"not finite")
            if turn:
                times[name].append(dt)
    want = {"unfused": (WARMUP_STEPS + STEPS * VARIANT_TURNS) if on_card
            else 0, "fused": 0}
    if counts != want:
        raise RuntimeError(f"variants: step-kernel launches {counts}, want "
                           f"{want}")
    row = {}
    for name, model in models.items():
        med = statistics.median(times[name])
        row[name] = dict(clips_per_s=BATCH / med, ms=med * 1e3,
                         kernels=_kernels_a_step(model, batch, gen))
        log(f"# variants: {name} bf16 batch {BATCH} DDIM-{STEPS} on {smi}: "
            f"{BATCH / med:.2f} clips/s, {med * 1e3:.1f} ms/call (median of "
            f"{VARIANT_TURNS}, in turns), {row[name]['kernels']} kernels a "
            f"step, {counts[name]} step-kernel launches")
    return row


def remat_variant(smi, device):
    """TPU.REMAT at the production width: stage 2 at batch 4, fp32,
    dropout 0.1, one step bit-equal to the step without it (loss, every
    gradient, the generator's state); then bf16 batch 64 with and without
    it, in turns: ms a step, and the peak memory over the step's start of
    its forward and backward (what remat trades) and of the whole step
    (AdamW's temporaries included)."""
    raw = synthetic_raw_batch(95, VARIANT_PARITY_BATCH,
                              mel_frames=PRODUCTION["mel_frames"])
    out = {}
    for remat in (False, True, False):
        cfg = copy.deepcopy(PRODUCTION)
        cfg["denoiser"]["remat"] = remat
        model = Convofusion(cfg, dtype="float32", device=device, seed=0)
        batch = train_batch(model, raw)
        trainer = Trainer(model)
        gen = torch.Generator(device=device).manual_seed(96)
        with trainer.training():
            loss, _ = trainer.compute_grads(batch, gen)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        out.setdefault(remat, []).append((loss, grads, gen.get_state()))
        del model, trainer
    (l0, g0, s0), (l1, g1, s1) = out[False][0], out[True][0]
    l2, g2, _ = out[False][1]
    plain_repeats = torch.equal(l0, l2) and all(
        torch.equal(g0[k], g2[k]) for k in g0)
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    log(f"# variants: remat fp32 batch {VARIANT_PARITY_BATCH} dropout "
        f"{PRODUCTION['denoiser']['dropout']}: loss {float(l0):.6g} / "
        f"{float(l1):.6g}, {len(g0) - len(differ)} of {len(g0)} gradients "
        f"bit-equal, generator state equal {torch.equal(s0, s1)}; the plain "
        f"step repeats bit-equal: {plain_repeats}")
    if not (torch.equal(l0, l1) and torch.equal(s0, s1) and not differ
            and set(g0) == set(g1)):
        raise RuntimeError(f"variants remat: not bit-equal (gradients "
                           f"{differ[:4]})")

    raw = synthetic_raw_batch(97, TRAIN_DIFFUSION_BATCH,
                              mel_frames=PRODUCTION["mel_frames"])
    runs = {}
    for remat in (False, True):
        cfg = copy.deepcopy(PRODUCTION)
        cfg["denoiser"]["remat"] = remat
        model = Convofusion(cfg, dtype="bfloat16", device=device, seed=0)
        trainer = Trainer(model)
        trainer.init_state()
        runs[remat] = (model, trainer, train_batch(model, raw),
                       torch.Generator(device=device).manual_seed(98))
    times = {False: [], True: []}
    peaks = {}
    on_card = torch.device(device).type == "cuda"
    for turn in range(VARIANT_WARMUP + VARIANT_TURNS):
        for remat, (model, trainer, batch, gen) in runs.items():
            with trainer.training():
                _sync(device)
                if on_card:
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, _ = trainer.compute_grads(batch, gen)
                if on_card:
                    backward_peak = torch.cuda.max_memory_allocated() - base
                trainer.apply_grads()
                _sync(device)
                dt = time.perf_counter() - t0
            if not math.isfinite(float(loss)):
                raise RuntimeError(f"variants remat={remat}: loss "
                                   f"{float(loss)}")
            peaks[remat] = ((backward_peak / 2**30,
                             (torch.cuda.max_memory_allocated() - base)
                             / 2**30) if on_card else (0.0, 0.0))
            if turn >= VARIANT_WARMUP:
                times[remat].append(dt)
    row = {}
    for remat in (False, True):
        med = statistics.median(times[remat])
        row["remat" if remat else "plain"] = dict(
            ms=med * 1e3, backward_peak_gib=peaks[remat][0],
            step_peak_gib=peaks[remat][1])
        log(f"# variants: stage 2 bf16 batch {TRAIN_DIFFUSION_BATCH} "
            f"{'with' if remat else 'without'} remat on {smi}: "
            f"{med * 1e3:.2f} ms a step (median of {VARIANT_TURNS}, in "
            f"turns); peak memory over the step's start: forward and "
            f"backward {peaks[remat][0]:.3f} GiB, the whole step "
            f"{peaks[remat][1]:.3f} GiB")
    return row


def raw_motion_variant(smi, device):
    """vae_type 'no' at the production width: bf16 batch 96 DDIM-50 with
    50 launches at (7, 96, 128, 189); fp32 batch 4 DDIM-10 card against
    CPU; 3 stage-2 training steps."""
    cfg = copy.deepcopy(PRODUCTION)
    cfg["vae_type"] = "no"
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=STEPS)
    model = Convofusion(cfg, dtype="bfloat16", device=device, seed=0)
    if model.vae is not None or model.latent_tokens != 128:
        raise RuntimeError("variants raw motion: the model has a VAE")
    raw = synthetic_raw_batch(101, BATCH, mel_frames=cfg["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    gen = torch.Generator(device=device).manual_seed(102)
    times = []
    for call in range(2):
        before = COUNTS["guided_step.launches"]
        t0 = time.perf_counter()
        motion, latents = model.sample(batch, gen)
        _sync(device)
        times.append(time.perf_counter() - t0)
        n = COUNTS["guided_step.launches"] - before
        if torch.device(device).type != "cuda":
            n = STEPS          # the plain version off the card
        if n != STEPS or tuple(motion.shape) != (BATCH, 128, 189) or \
                not torch.equal(motion, latents) or \
                not torch.isfinite(motion).all():
            raise RuntimeError(f"variants raw motion call {call}: {n} "
                               f"launches, motion {tuple(motion.shape)}")
    shape = ((BATCH, 128, 189), torch.bfloat16)
    if torch.device(device).type == "cuda" and \
            shape not in gs_mod.guided_step.shapes:
        raise RuntimeError("variants raw motion: no launch at (7, 96, 128, "
                           "189) bf16")
    row = dict(clips_per_s=BATCH / times[1], ms=times[1] * 1e3,
               in_path_us=None)
    if torch.device(device).type == "cuda":
        # the step kernel's device time a launch inside the reverse loop
        keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask",
                "melspec_lsn", "active_passive_lsn", "lsn_id")
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            cond, masks = model.encode_conditions(*(batch[k] for k in keys))
            unc, umasks = model.encode_uncond(batch)
            model.diffusion_reverse(cond, masks, unc, umasks, BATCH,
                                    num_inference_steps=PROFILE_STEPS,
                                    generator=gen)
            torch.cuda.synchronize()
        row["in_path_us"] = kernel_in_path_us(
            [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA], PROFILE_STEPS)
    log(f"# variants: raw motion bf16 batch {BATCH} DDIM-{STEPS} on {smi}: "
        f"{BATCH / times[1]:.2f} clips/s, {times[1] * 1e3:.1f} ms/call, "
        f"{STEPS} launches a call at (7, {BATCH}, 128, 189); the step kernel "
        f"{row['in_path_us']} us a launch in the loop ({PROFILE_STEPS} "
        f"profiled steps)")
    del model

    b = VARIANT_PARITY_BATCH
    raw = synthetic_raw_batch(103, b, mel_frames=cfg["mel_frames"])
    init, steps = _noise(np.random.default_rng(104), VARIANT_PARITY_STEPS,
                         (b, 128, 189))
    (dev_out, n), (cpu_out, _) = (
        _fp32_sample(cfg, side, raw, init, steps) for side in (device, "cpu"))
    if torch.device(device).type == "cuda" and n != VARIANT_PARITY_STEPS:
        raise RuntimeError(f"variants raw motion parity: {n} launches")
    _card_cpu_gap(f"raw motion fp32 batch {b} DDIM-{VARIANT_PARITY_STEPS} "
                  f"card vs CPU", dev_out, cpu_out)

    model = Convofusion(cfg, dtype="bfloat16", device=device, seed=0)
    raw = synthetic_raw_batch(105, TRAIN_DIFFUSION_BATCH,
                              mel_frames=cfg["mel_frames"])
    batch = train_batch(model, raw)
    trainer = Trainer(model)
    trainer.init_state()
    gen = torch.Generator(device=device).manual_seed(106)
    losses, norms = [], []
    with trainer.training():
        for _ in range(3):
            loss, _ = trainer.compute_grads(batch, gen)
            norms.append(torch.linalg.vector_norm(torch.stack([
                p.grad.float().norm() for n, p in model.named_parameters()
                if n.startswith("denoiser.") and p.grad is not None])))
            trainer.apply_grads()
            losses.append(loss)
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    log(f"# variants: raw motion stage 2 bf16 batch "
        f"{TRAIN_DIFFUSION_BATCH}: losses {[round(x, 5) for x in losses]}, "
        f"the denoiser's gradient norm {[round(x, 4) for x in norms]}")
    if not all(math.isfinite(x) for x in losses + norms) or \
            not min(norms) > 0:
        raise RuntimeError("variants raw motion training: a loss or the "
                           "denoiser's gradient is not finite or zero")
    return row


def overfit_variant(device):
    """The learning proof's pipeline (``train/overfit.run``) at a token
    budget on the card: every key of JAX's committed result, finite."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "docs", "artifacts", "overfit_result.json")) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overfit") as tmp:
        t0 = time.perf_counter()
        out = overfit.run(tmp, vae_epochs=OVERFIT_EPOCHS,
                          diff_epochs=OVERFIT_EPOCHS,
                          infer_steps=VARIANT_PARITY_STEPS, device=device,
                          log=lambda *a: None)
        wall = time.perf_counter() - t0

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    got = dict(leaves(out))
    missing = [k for k, _ in leaves(want) if k not in got]
    bad = [k for k, v in leaves(want) if isinstance(v, (int, float))
           and k in got and not math.isfinite(got[k])]
    log(f"# variants: overfit.run {OVERFIT_EPOCHS} + {OVERFIT_EPOCHS} epochs,"
        f" DDIM-{VARIANT_PARITY_STEPS}, on the card in {wall:.1f} s (stages "
        f"{ {k: round(v, 1) for k, v in out['stage_seconds'].items()} }): "
        f"vae relRMSE {out['vae_recon_rel_rmse']:.4f}, repro {out['repro']}")
    if missing or bad:
        raise RuntimeError(f"variants overfit: keys missing {missing}, not "
                           f"finite {bad}")
    return wall


def phase_variants(smi, device="cuda"):
    """Phase 16: the fused layout, REMAT, raw motion and the learning
    proof's pipeline."""
    row = {}
    for name, fn in (("fused", lambda: fused_variant(smi, device)),
                     ("remat", lambda: remat_variant(smi, device)),
                     ("raw_motion", lambda: raw_motion_variant(smi, device)),
                     ("overfit_s", lambda: overfit_variant(device))):
        t0 = time.perf_counter()
        row[name] = fn()
        log(f"# variants: {name} part in {time.perf_counter() - t0:.1f} s")
    PHASE_RESULTS["variants"] = row


def ablated_vae_parity(device):
    """fp32 batch 2 DDIM-10 sample() on the card against the CPU, seeded
    weights, numpy-made inputs and noise, for the post-norm learned-PE
    MLP_DIST VAE with the denoiser's learned memory PE, and for the
    all_encoder VAE; exactly 10 launches a card call."""
    base = copy.deepcopy(PRODUCTION)
    base["scheduler"].update(variant="ddim",
                             num_inference_timesteps=ABLATION_STEPS)
    post = copy.deepcopy(base)
    post["motion_vae"].update(normalize_before=False,
                              position_embedding="learned", mlp_dist=True)
    post["denoiser"]["position_embedding"] = "learned"
    all_enc = copy.deepcopy(base)
    all_enc["motion_vae"]["arch"] = "all_encoder"
    b, lat = ABLATION_PARITY_BATCH, base["latent_dim"][1]
    raw = synthetic_raw_batch(111, b, mel_frames=base["mel_frames"])
    init, steps = _noise(np.random.default_rng(112), ABLATION_STEPS,
                         (b, 16, lat))
    on_card = torch.device(device).type == "cuda"
    row = {}
    for name, cfg in (("post_norm_learned_mlp_dist", post),
                      ("all_encoder", all_enc)):
        (dev_out, n), (cpu_out, _) = (
            _fp32_sample(cfg, side, raw, init, steps)
            for side in (device, "cpu"))
        if on_card and n != ABLATION_STEPS:
            raise RuntimeError(f"ablations {name}: {n} launches, want "
                               f"{ABLATION_STEPS}")
        row[name] = _card_cpu_gap(
            f"{name} fp32 batch {b} DDIM-{ABLATION_STEPS} card vs CPU, {n} "
            f"launches on the card", dev_out, cpu_out, phase="ablations")
    return row


def trans_enc_parity(device):
    """The trans_enc denoiser at the production width, fp32, dropout 0,
    batch 4, on the card against the CPU: one stage-2 loss and its
    gradients (phase 11's bounds), one unguided DDIM-10 sample() (phase 4's
    bounds, no launch), and a guided call that raises before any work."""
    cfg = without_dropout(PRODUCTION)
    cfg["denoiser"]["arch"] = "trans_enc"
    cfg["guidance_scale"] = 1.0
    cfg["scheduler"].update(variant="ddim",
                            num_inference_timesteps=ABLATION_STEPS)
    b, lat = TRANS_ENC_BATCH, cfg["latent_dim"][1]
    raw = synthetic_raw_batch(121, b, mel_frames=cfg["mel_frames"])
    rng = np.random.default_rng(122)
    draws = train_draws(rng, "diffusion", b, 1, lat)[0]
    init, steps = _noise(rng, ABLATION_STEPS, (b, 16, lat))
    out = {}
    for side in (device, "cpu"):
        model = Convofusion(cfg, dtype="float32", device=side, seed=0)
        batch = train_batch(model, raw)
        trainer = Trainer(model)
        with trainer.training():
            loss, _ = trainer.compute_grads(batch, None, draws)
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
        before = COUNTS["guided_step.launches"]
        motion, latents = model.sample(batch, num_inference_steps=len(steps),
                                       init_noise=init, step_noise=steps)
        n = COUNTS["guided_step.launches"] - before
        # guided sampling: no work, a ValueError naming trans_enc
        model.guidance_scale, model.do_classifier_free_guidance = 7.5, True
        try:
            model.sample(batch, torch.Generator(device=side).manual_seed(0),
                         num_inference_steps=len(steps))
        except ValueError as e:
            if "trans_enc" not in str(e):
                raise
        else:
            raise RuntimeError("ablations trans_enc: guided sample() ran")
        if COUNTS["guided_step.launches"] != before + n or n:
            raise RuntimeError(f"ablations trans_enc: {n} launches")
        out[side] = (float(loss), grads,
                     (motion.float().cpu(), latents.cpu()))
        del model, trainer
    (l_d, g_d, s_d), (l_c, g_c, s_c) = out[device], out["cpu"]
    d_loss = abs(l_d - l_c) / abs(l_c)
    worst, worst_name = _grad_worst(g_d, g_c)
    log(f"# ablations: trans_enc stage 2 fp32 batch {b} card vs CPU: loss "
        f"{l_c:.6g}, relative gap {d_loss:.3g} (tolerance "
        f"{TRAIN_LOSS_RTOL}); {len(g_c)} gradients, the worst at "
        f"{worst:.3g} of its tolerance ({worst_name}); a guided sample() "
        f"raised ValueError on both sides")
    if set(g_d) != set(g_c) or not any(
            k.startswith("denoiser.encoder.") for k in g_c):
        raise RuntimeError("ablations trans_enc: gradient sets differ")
    if not d_loss <= TRAIN_LOSS_RTOL or not worst <= 1.0:
        raise RuntimeError(f"ablations trans_enc: loss gap {d_loss}, "
                           f"gradient {worst_name} at {worst}x")
    dm, dl = _card_cpu_gap(
        f"trans_enc unguided fp32 batch {b} DDIM-{ABLATION_STEPS} card vs "
        f"CPU, 0 launches", s_d, s_c, phase="ablations")
    return {"loss_rel_gap": d_loss, "grad_worst": worst,
            "sample_gaps": (dm, dl)}


def module_parity(device):
    """EmbedAction in eval and in guided eval, the text condition's
    emb_proj (ReLU + Linear of a trans_enc denoiser) and
    TextAudioController in the spk-ta mode, at the production width,
    seeded weights: the card against the CPU within 1e-5."""
    d = PRODUCTION["denoiser"]["text_encoded_dim"]
    t, mel_frames = PRODUCTION["text_pad_len"], PRODUCTION["mel_frames"]
    rng = np.random.default_rng(131)
    action = torch.from_numpy(rng.integers(0, 10, (8, 1)))
    text = torch.from_numpy(rng.standard_normal((4, t, d)).astype(
        np.float32))
    mask = torch.ones(4, t, dtype=torch.bool)
    mask[1:, t // 2:] = False
    mel = torch.from_numpy(rng.standard_normal((4, mel_frames, 80)).astype(
        np.float32))
    den = Denoiser(latent_dim=PRODUCTION["latent_dim"][1],
                   **{**PRODUCTION["denoiser"], "arch": "trans_enc",
                      "condition": "text"})
    cases = (
        ("EmbedAction eval", EmbedAction(10, d, guidance_scale=1.0),
         lambda m, dev: m(action.to(dev))),
        ("EmbedAction guided", EmbedAction(10, d, guidance_scale=7.5),
         lambda m, dev: m(action.to(dev))),
        ("text emb_proj", den.emb_proj, lambda m, dev: m(text.to(dev))),
        ("TextAudioController spk-ta",
         TextAudioController(out_dim=d, audio_max_length=mel_frames),
         lambda m, dev: torch.cat([
             o.flatten() for o in m(text.to(dev), mask.to(dev),
                                    mel.to(dev), "spk-ta")
             if torch.is_tensor(o) and o.is_floating_point()])),
    )
    gaps = {}
    for i, (name, module, run) in enumerate(cases):
        layers.init_weights(module, torch.Generator().manual_seed(133 + i))
        module.eval()
        with torch.no_grad():
            want = run(module, "cpu")
            got = run(copy.deepcopy(module).to(device), device).cpu()
        gaps[name] = float((got - want).abs().max())
        if got.shape != want.shape or not gaps[name] <= ABLATION_MODULE_ATOL:
            raise RuntimeError(f"ablations {name}: card vs CPU "
                               f"{gaps[name]}")
    log(f"# ablations: modules card vs CPU at width {d}, max|diff| "
        f"{ {k: f'{v:.3g}' for k, v in gaps.items()} } (tolerance "
        f"{ABLATION_MODULE_ATOL})")
    return gaps


def _profile_reverse(model, batch, gen):
    """Wall ms, device busy ms and kernels a step of PROFILE_STEPS reverse
    steps under the profiler."""
    keys = ("spk_ids", "spk_tmask", "lsn_ids", "lsn_tmask", "melspec_lsn",
            "active_passive_lsn", "lsn_id")
    b = batch["lsn_ids"].shape[0]
    with torch.inference_mode():
        cond, masks = model.encode_conditions(*(batch[k] for k in keys))
        unc, umasks = model.encode_uncond(batch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.diffusion_reverse(cond, masks, unc, umasks, b,
                                    num_inference_steps=PROFILE_STEPS,
                                    generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (round(wall_ms / PROFILE_STEPS, 2),
            round(sum(_device_us(e) for e in kernels) / 1e3 / PROFILE_STEPS,
                  2),
            sum(e.count for e in kernels) // PROFILE_STEPS)


def step_paths(smi, device):
    """TPU.PALLAS_STEP false against true in sample(): the production
    model, bf16 batch 96 DDIM-50, a DDIM-2 warm-up and STEP_PATH_TURNS
    timed calls of each path in turns of alternating order (50 launches a kernel call,
    none a plain one), and a profile of a few steps of each; then fp32
    batch 2: one reverse step of both paths within 1e-5, and DDIM-10 of
    both within phase 4's bounds."""
    on_card = torch.device(device).type == "cuda"
    model = Convofusion(PRODUCTION, dtype="bfloat16", device=device, seed=1)
    raw = synthetic_raw_batch(141, BATCH, mel_frames=PRODUCTION["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    gen = torch.Generator(device=device).manual_seed(142)
    times = {"kernel": [], "plain": []}
    # a warm-up of each, then turns in alternating order: kernel, plain,
    # plain, kernel, ...
    for turn in range(1 + STEP_PATH_TURNS):
        steps = STEPS if turn else WARMUP_STEPS
        for name in (("kernel", "plain") if turn % 2 else
                     ("plain", "kernel")):
            model.use_step_kernel = name == "kernel"
            before = COUNTS["guided_step.launches"]
            t0 = time.perf_counter()
            motion, _ = model.sample(batch, gen, steps)
            _sync(device)
            dt = time.perf_counter() - t0
            n = COUNTS["guided_step.launches"] - before
            if n != (steps if name == "kernel" and on_card else 0) or \
                    tuple(motion.shape) != (BATCH, 128, 189) or \
                    not torch.isfinite(motion).all():
                raise RuntimeError(f"ablations {name} step path: {n} "
                                   f"launches, motion {tuple(motion.shape)}")
            if turn:
                times[name].append(dt)
    ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    prof = {}
    if on_card:
        for name in times:
            model.use_step_kernel = name == "kernel"
            prof[name] = _profile_reverse(model, batch, gen)
    model.use_step_kernel = True
    del model
    log(f"# ablations: sample() bf16 batch {BATCH} DDIM-{STEPS} on {smi}, "
        f"{STEP_PATH_TURNS} timed calls a path in turns: with the step "
        f"kernel {ms['kernel']:.1f} ms a call "
        f"({[round(x * 1e3, 1) for x in times['kernel']]}), TPU.PALLAS_STEP "
        f"false {ms['plain']:.1f} ms "
        f"({[round(x * 1e3, 1) for x in times['plain']]}): the kernel saves "
        f"{(ms['plain'] - ms['kernel']) / STEPS:.3f} ms a step; "
        f"{PROFILE_STEPS} profiled steps (wall ms, device busy ms, kernels "
        f"a step): {prof}")

    cfg = copy.deepcopy(PRODUCTION)
    cfg["scheduler"].update(variant="ddim",
                            num_inference_timesteps=ABLATION_STEPS)
    model = Convofusion(cfg, dtype="float32", device=device, seed=0)
    b, lat = ABLATION_PARITY_BATCH, cfg["latent_dim"][1]
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(
        143, b, mel_frames=cfg["mel_frames"]))
    rng = np.random.default_rng(144)
    gaps = {}
    for n_steps, bounds in ((1, (STEP_PATHS_ATOL, STEP_PATHS_ATOL)),
                            (ABLATION_STEPS,
                             (PARITY_ATOL, VARIANT_LATENT_ATOL))):
        init, steps = _noise(rng, n_steps, (b, 16, lat))
        outs = {}
        for use in (True, False):
            model.use_step_kernel = use
            motion, latents = model.sample(batch, num_inference_steps=n_steps,
                                           init_noise=init, step_noise=steps)
            outs[use] = (motion.float().cpu(), latents.cpu())
        gaps[n_steps] = _card_cpu_gap(
            f"fp32 batch {b} DDIM-{n_steps} on the card, the kernel path "
            f"against TPU.PALLAS_STEP false", outs[True], outs[False],
            phase="ablations", bounds=bounds)
    del model
    return {"batch": BATCH, "dtype": "bfloat16", "steps": STEPS,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "fp32_gaps": gaps}


def ablation_cli(smi, device=None):
    """An ablation config through the CLIs at the production configs'
    width, bf16: cli/train stage 1 (config_vae_beatdnd.yaml, 2 steps) with
    the post-norm, learned-PE, MLP_DIST VAE; stage 2 (config_cf_beatdnd.
    yaml, 2 steps) from its file; a save and load of that model,
    bit-equal; cli/test on one batch of 32 at DDIM-50 (WEG off: phase 14
    runs it), 50 launches."""
    dev_arg = ["--device", device] if device else []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ablations") as tmp, \
            asset_root(os.path.join(tmp, "assets")):
        t0 = time.perf_counter()
        write_synthetic_spiece(os.path.join(tmp, "assets", "t5-base",
                                            "spiece.model"))
        root = make_fixture_pair(os.path.join(tmp, "data"),
                                 n_files=ABLATION_CLI_FILES)
        log(f"# ablations: spiece.model and a fixture tree of "
            f"{ABLATION_CLI_FILES} files in {time.perf_counter() - t0:.2f} s")
        common = ["TRAIN.END_EPOCH=1", "LOGGER.VAL_EVERY_STEPS=1",
                  "LOGGER.SACE_CHECKPOINT_EPOCH=1",
                  f"TRAIN.BATCH_SIZE={ABLATION_CLI_BATCH}",
                  "TPU.COMPUTE_DTYPE=bfloat16"] + ABLATION_OVERRIDES
        exp = os.path.join(tmp, "experiments", "convofusion")
        walls = {}
        t0 = time.perf_counter()
        s1 = cli_train.main(_cli_argv(tmp, root, "abl_vae", common,
                                      cfg="config_vae_beatdnd.yaml")
                            + dev_arg)
        walls["stage1_s"] = time.perf_counter() - t0
        vae_ckpt = ckpt_lib.latest_checkpoint(os.path.join(
            exp, "abl_vae", "checkpoints"))
        steps1 = [e["steps"] for e in s1.train_stats.epochs]
        if not s1.vae.mlp_dist or steps1 != [2]:
            raise RuntimeError(f"ablations stage 1: steps {steps1}")
        del s1
        argv2 = _cli_argv(tmp, root, "abl_cf", common + [
            f"TRAIN.PRETRAINED_VAE={vae_ckpt}"])
        t0 = time.perf_counter()
        s2 = cli_train.main(argv2 + dev_arg)
        walls["stage2_s"] = time.perf_counter() - t0
        steps2 = [e["steps"] for e in s2.train_stats.epochs]
        rows = (_metric_rows(os.path.join(exp, "abl_vae"), "stage 1")
                + _metric_rows(os.path.join(exp, "abl_cf"), "stage 2"))
        if steps2 != [2]:
            raise RuntimeError(f"ablations stage 2: steps {steps2}")

        # the trained model saved without its trunk, loaded into a fresh
        # model of the same seed whose other weights are zeroed
        seed = int(parse_args("train", argv2).SEED_VALUE)
        path, save_ms, _ = _save_timed(os.path.join(tmp, "roundtrip"), 0, s2)
        fresh = Convofusion(s2.cfg, dtype="bfloat16", device=s2.device,
                            seed=seed)
        with torch.no_grad():
            for n, p in fresh.named_parameters():
                if not n.startswith(ckpt_lib.TRUNK):
                    p.zero_()
        ckpt_lib.load_checkpoint(path, fresh)
        differ = _bit_equal(fresh, s2)
        if differ:
            raise RuntimeError(f"ablations: {len(differ)} tensors differ "
                               f"after the round trip: {differ[:4]}")
        n_tensors = len(s2.state_dict())
        del s2, fresh

        ckpt2 = ckpt_lib.latest_checkpoint(os.path.join(exp, "abl_cf",
                                                        "checkpoints"))
        calls = []
        t0 = time.perf_counter()
        with launches_per_sample(calls):
            run = cli_test.main(_cli_argv(
                tmp, root, "abl_test", common + DDIM_OVERRIDES + [
                    f"TEST.CHECKPOINTS={ckpt2}",
                    "TEST.SAVE_PREDICTIONS=false",
                    "TRAIN.ABLATION.WEG_TYPE=no"]) + dev_arg)
        walls["test_s"] = time.perf_counter() - t0
        on_card = device != "cpu"
        log(f"# ablations: the CLIs on {smi}, bf16: stage 1 steps {steps1} "
            f"at batch {ABLATION_CLI_BATCH} in {walls['stage1_s']:.1f} s, "
            f"stage 2 steps {steps2} at batch {ABLATION_CLI_BATCH} in "
            f"{walls['stage2_s']:.1f} s, total/train "
            f"{[round(r['total/train'], 4) for r in rows]}; {n_tensors} "
            f"tensors bit-equal after a save ({save_ms:.1f} ms) and load; "
            f"cli/test batches {run.batch_sizes} at DDIM-{STEPS} in "
            f"{walls['test_s']:.1f} s (sample {_ms(run.sample_ms)} ms), "
            f"step-kernel launches {calls}")
        if run.batch_sizes != [32] or (on_card and calls != [STEPS]) or \
                not all(np.isfinite(lat).all() for lat in run.latents):
            raise RuntimeError(f"ablations test CLI: batches "
                               f"{run.batch_sizes}, launches {calls}")
    return walls


def phase_ablations(smi, device="cuda"):
    """Phase 17: every model option the JAX package builds."""
    row = {}
    for name, fn in (("vae_parity", lambda: ablated_vae_parity(device)),
                     ("trans_enc", lambda: trans_enc_parity(device)),
                     ("modules", lambda: module_parity(device)),
                     ("step_paths", lambda: step_paths(smi, device)),
                     ("cli", lambda: ablation_cli(smi, device))):
        t0 = time.perf_counter()
        row[name] = fn()
        log(f"# ablations: {name} part in {time.perf_counter() - t0:.1f} s")
    PHASE_RESULTS["ablations"] = row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env():
    """torchrun's environment for one process (rank 0 of world size 1, a
    free localhost port) while open."""
    values = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
              "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def step_records(record, sigterm_after=None):
    """While open, each Trainer step appends its returned loss (on the
    device) to ``record['losses']``; the first step's weights are copied
    into ``record['after_1']``; with ``sigterm_after`` = n the process
    signals itself SIGTERM after step n, as a preemption would."""
    compute, apply = Trainer.compute_grads, Trainer.apply_grads

    def compute_grads(self, *args, **kwargs):
        loss, terms = compute(self, *args, **kwargs)
        record.setdefault("losses", []).append(loss.clone())
        return loss, terms

    def apply_grads(self):
        out = apply(self)
        n = record["steps"] = record.get("steps", 0) + 1
        if n == 1:
            record["after_1"] = {k: v.clone() for k, v in
                                 self.model.state_dict().items()}
        if n == sigterm_after:
            signal.raise_signal(signal.SIGTERM)
        return out

    Trainer.compute_grads, Trainer.apply_grads = compute_grads, apply_grads
    try:
        yield record
    finally:
        Trainer.compute_grads, Trainer.apply_grads = compute, apply


def _max_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    if set(a) != set(b):
        raise RuntimeError(f"state dicts differ in names: "
                           f"{sorted(set(a) ^ set(b))[:4]}")
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def ddp_train(smi, device=None):
    """Stage-2 cli/train at the YAML batch of 64, DISTRIBUTED_EPOCHS
    epochs of one step: without a group, then with TPU.MULTIHOST under a
    world-size-1 NCCL group (torchrun's environment set in-process): the
    losses and weights bit-equal, rank 0's files written, the barriers
    passed, no host wait inside its second step; then a SIGTERM after step
    1 under the group checkpoints epoch 0, and TRAIN.RESUME from that file
    ends within 1e-6 of the straight run's weights."""
    dev_arg = ["--device", device] if device else []
    on_card = device != "cpu"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp") as tmp, \
            asset_root(os.path.join(tmp, "assets")):
        write_synthetic_spiece(os.path.join(tmp, "assets", "t5-base",
                                            "spiece.model"))
        roots = make_fixture_pair(os.path.join(tmp, "data"),
                                  n_files=DISTRIBUTED_FILES)
        exp = os.path.join(tmp, "experiments", "convofusion")
        over = [f"TRAIN.END_EPOCH={DISTRIBUTED_EPOCHS}",
                "LOGGER.VAL_EVERY_STEPS=0", "LOGGER.SACE_CHECKPOINT_EPOCH=1",
                "TPU.COMPUTE_DTYPE=bfloat16"]
        group = over + ["TPU.MULTIHOST=true"]
        runs, found = {}, []
        barrier = dist_mesh.process_barrier

        for name, extra, sigterm in (("plain", over, None),
                                     ("group", group, None),
                                     ("preempt", group, 1),
                                     ("resume", group + ["TRAIN.RESUME=true"],
                                      None)):
            exp_name = "preempt" if name == "resume" else name
            checked = sync_checked_step(1, found) \
                if on_card and name == "group" else contextlib.nullcontext()
            barriers = []

            def counted_barrier(name, *args, **kwargs):
                barriers.append(name)
                return barrier(name, *args, **kwargs)

            t0 = time.perf_counter()
            with step_records({}, sigterm) as rec, checked, \
                    (torchrun_env() if extra is not over
                     else contextlib.nullcontext()):
                dist_mesh.process_barrier = counted_barrier
                try:
                    model = cli_train.main(_cli_argv(tmp, roots, exp_name,
                                                     extra) + dev_arg)
                finally:
                    dist_mesh.process_barrier = barrier
            if dist_mesh.is_initialized():
                raise RuntimeError(f"distributed {name}: the group outlived "
                                   f"its run")
            runs[name] = dict(
                rec, seconds=time.perf_counter() - t0, barriers=barriers,
                start=model.train_stats.start_epoch,
                steps=[e["steps"] for e in model.train_stats.epochs],
                weights={k: v.clone() for k, v in model.state_dict().items()},
                files=sorted(os.listdir(os.path.join(exp, exp_name,
                                                     "checkpoints"))))
            del model
        plain, grp = runs["plain"], runs["group"]
        pre, res = runs["preempt"], runs["resume"]
        with open(os.path.join(exp, "group", "metrics.jsonl")) as f:
            metric_rows = [json.loads(line) for line in f]
    losses_equal = len(plain["losses"]) == len(grp["losses"]) and all(
        torch.equal(a, b) for a, b in zip(plain["losses"], grp["losses"]))
    group_gap = _max_gap(plain["weights"], grp["weights"])
    preempt_gap = _max_gap(pre["after_1"], plain["after_1"])
    resume_gap = _max_gap(res["weights"], plain["weights"])
    want_files = [f"epoch={e}.ckpt" for e in range(DISTRIBUTED_EPOCHS)]
    log(f"# distributed: stage-2 cli/train bf16 batch 64 on {smi}, "
        f"{DISTRIBUTED_EPOCHS} epochs of {plain['steps']} steps: without a "
        f"group {plain['seconds']:.1f} s, under a world-size-1 group (NCCL "
        f"on the card) "
        f"{grp['seconds']:.1f} s: losses bit-equal {losses_equal} "
        f"({[round(float(x), 6) for x in grp['losses']]}), max|weight gap| "
        f"{group_gap:.3g}; rank 0 wrote {grp['files']} and "
        f"{len(metric_rows)} metrics rows; barriers {grp['barriers']}; no "
        f"wait for the card inside step 2 (CUDA sync checker): {not found}")
    log(f"# distributed: SIGTERM after step 1 under the group: steps "
        f"{pre['steps']}, files {pre['files']}, the step-1 weights "
        f"{preempt_gap:.3g} from the straight run's; TRAIN.RESUME from "
        f"epoch {res['start']}: steps {res['steps']}, final weights "
        f"{resume_gap:.3g} from the straight run's (tol "
        f"{DISTRIBUTED_RESUME_ATOL})")
    if not losses_equal or group_gap != 0.0 or found or \
            grp["files"] != want_files or \
            len(metric_rows) != DISTRIBUTED_EPOCHS or \
            grp["barriers"] != [f"train/epoch/{e}" for e in
                                range(DISTRIBUTED_EPOCHS)] + ["train/end"] or \
            plain["steps"] != [1] * DISTRIBUTED_EPOCHS:
        raise RuntimeError("distributed: the group's run differs from the "
                           "run without it")
    if pre["steps"] != [1] or pre["files"] != want_files[:1] or \
            res["start"] != 1 or res["steps"] != [1] or \
            not preempt_gap <= DISTRIBUTED_RESUME_ATOL or \
            not resume_gap <= DISTRIBUTED_RESUME_ATOL:
        raise RuntimeError("distributed: the preempted run or its resume "
                           "differs from the straight run")
    return {"plain_s": plain["seconds"], "group_s": grp["seconds"],
            "resume_gap": resume_gap}


def t5_dropout(smi, device="cuda"):
    """Stage 2 at batch 64 through the Trainer, bf16 with fp32 masters,
    T5_DROPOUT_STEPS steps with the T5 trunk's dropout at T5_DROPOUT: the
    trunk bit-identical after them, a second run from the same seed
    bit-equal, step 1's loss unlike the rate-0 run's, the train CLI's trunk
    cache off; ms a step beside phase 12's rate-0 step."""
    raw = synthetic_raw_batch(181, TRAIN_DIFFUSION_BATCH,
                              mel_frames=PRODUCTION["mel_frames"])
    runs = {}
    for name, rate in (("a", T5_DROPOUT), ("b", T5_DROPOUT), ("rate 0", 0.0)):
        cfg = copy.deepcopy(PRODUCTION)
        cfg["text_encoder"]["dropout"] = rate
        model = Convofusion(cfg, dtype="bfloat16", device=device, seed=2)
        batch = train_batch(model, raw)
        trunk = model.text_encoder.text_model
        before = {k: v.clone() for k, v in trunk.state_dict().items()}
        trainer = Trainer(model)
        trainer.init_state()
        gen = torch.Generator(device=model.device).manual_seed(182)
        losses, times = [], []
        with trainer.training():
            for _ in range(T5_DROPOUT_STEPS):
                t0 = time.perf_counter()
                loss, _ = trainer.compute_grads(batch, gen)
                trainer.apply_grads()
                _sync(device)
                times.append(time.perf_counter() - t0)
                losses.append(loss)
        runs[name] = dict(
            losses=[float(x) for x in losses],
            trunk_same=_max_gap(before, trunk.state_dict()) == 0.0,
            weights={k: v.clone() for k, v in model.state_dict().items()},
            ms=statistics.median(times[1:]) * 1e3,
            cache=cli_train.uses_trunk_cache(model, {}))
        del model, trainer, batch
    a, b, zero = runs["a"], runs["b"], runs["rate 0"]
    repeat = a["losses"] == b["losses"] and \
        _max_gap(a["weights"], b["weights"]) == 0.0
    rate0_ms = PHASE_RESULTS.get("train", {}).get("stage2_ids", {}).get("ms")
    log(f"# distributed: T5 trunk dropout {T5_DROPOUT}, stage 2 bf16 batch "
        f"{TRAIN_DIFFUSION_BATCH} through the Trainer on {smi}: losses "
        f"{[round(x, 6) for x in a['losses']]} (rate 0: "
        f"{[round(x, 6) for x in zero['losses']]}); the trunk bit-identical "
        f"after {T5_DROPOUT_STEPS} steps {a['trunk_same']}; a second run "
        f"bit-equal {repeat}; the train CLI's trunk cache "
        f"{'on' if a['cache'] else 'off'} (rate 0: "
        f"{'on' if zero['cache'] else 'off'}); {a['ms']:.2f} ms a step "
        f"(median of {T5_DROPOUT_STEPS - 1}) against {zero['ms']:.2f} ms at "
        f"rate 0 here and phase 12's {rate0_ms} ms")
    if not (a["trunk_same"] and b["trunk_same"] and zero["trunk_same"]
            and repeat and a["losses"][0] != zero["losses"][0]
            and not a["cache"] and zero["cache"]
            and all(math.isfinite(x) for x in a["losses"])):
        raise RuntimeError("distributed: T5 trunk dropout")
    return {"ms": a["ms"], "rate0_ms": zero["ms"]}


def charsmap_test_cli(smi, device=None):
    """The test CLI with a synthesized 32k spiece.model that carries a
    Precompiled charsmap, on phase 14's tree whose transcripts hold curly
    quotes, accents, NBSP, a ligature and full-width letters: one batch of
    32 at DDIM-50 (WEG off: phase 14 runs it), exactly 50 launches; the
    token ids the card got equal the same tokenizer's on the host; ms to
    tokenize 32 texts with the charsmap and without."""
    dev_arg = ["--device", device] if device else []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_charsmap") as tmp, \
            asset_root(os.path.join(tmp, "assets")):
        spiece = write_synthetic_spiece(os.path.join(
            tmp, "assets", "t5-base", "spiece.model"), charsmap=True)
        plain = write_synthetic_spiece(os.path.join(tmp, "plain.model"))
        roots = make_fixture_pair(os.path.join(tmp, "data"),
                                  n_files=CLI_BEAT_FILES,
                                  words=CHARSMAP_WORDS)
        seen = []
        prepare = cli_test._prepare

        def recorded(model, batch, run):
            arrays, tb_spk, tb_lsn = prepare(model, batch, run)
            seen.append((model.text_pad_len, list(batch["text_spk"]),
                         list(batch["text_lsn"]), arrays["spk_ids"].cpu(),
                         arrays["lsn_ids"].cpu(),
                         type(model.tokenizer).__name__))
            return arrays, tb_spk, tb_lsn

        calls = []
        cli_test._prepare = recorded
        t0 = time.perf_counter()
        try:
            with launches_per_sample(calls):
                run = cli_test.main(_cli_argv(
                    tmp, roots, "charsmap", DDIM_OVERRIDES + [
                        "TEST.SAVE_PREDICTIONS=false",
                        "TRAIN.ABLATION.WEG_TYPE=no"]) + dev_arg)
        finally:
            cli_test._prepare = prepare
        wall = time.perf_counter() - t0
        host = {name: SentencePieceTokenizer(path)
                for name, path in (("charsmap", spiece), ("plain", plain))}
        pad, spk, lsn, spk_ids, lsn_ids, tok_name = seen[0]
        same = all(
            np.array_equal(host["charsmap"](texts, pad_to=pad).input_ids,
                           ids.numpy())
            for texts, ids in ((spk, spk_ids), (lsn, lsn_ids)))
        texts = lsn          # BEAT's speaker text is the uncond text
        non_ascii = sum(any(ord(c) > 127 for c in t) for t in texts)
        normalized = sum(host["charsmap"].tok.normalizer.normalize(t) != t
                         for t in texts)
        tok_ms = {}
        for name, tok in host.items():
            samples = []
            for _ in range(5):
                t1 = time.perf_counter()
                tok(texts, pad_to=pad)
                samples.append((time.perf_counter() - t1) * 1e3)
            tok_ms[name] = statistics.median(samples)
    on_card = device != "cpu"
    log(f"# distributed: cli/test bf16 DDIM-{STEPS} with a charsmap "
        f"spiece.model ({tok_name}) on {smi}: batches {run.batch_sizes} in "
        f"{wall:.1f} s, step-kernel launches {calls}; {non_ascii} of "
        f"{len(texts)} texts non-ASCII, {normalized} changed by the "
        f"charsmap; the card's token ids equal the host tokenizer's: {same}; "
        f"32 texts tokenized in {tok_ms['charsmap']:.2f} ms with the "
        f"charsmap, {tok_ms['plain']:.2f} ms without (median of 5)")
    if run.batch_sizes != [32] or (on_card and calls != [STEPS]) or \
            not same or tok_name != "SentencePieceTokenizer" or \
            not non_ascii or not normalized or \
            not all(np.isfinite(x).all() for x in run.latents):
        raise RuntimeError(f"distributed: the charsmap test CLI: batches "
                           f"{run.batch_sizes}, launches {calls}, ids equal "
                           f"{same}, tokenizer {tok_name}")
    return {"tokenize_ms": tok_ms, "seconds": wall}


def phase_distributed(smi, device="cuda"):
    """Phase 18: data parallelism, T5 trunk dropout, the t5 tokenizer's
    charsmap on a real path."""
    row = {}
    for name, fn in (("ddp_train", lambda: ddp_train(smi, device)),
                     ("t5_dropout", lambda: t5_dropout(smi, device)),
                     ("charsmap", lambda: charsmap_test_cli(smi, device))):
        t0 = time.perf_counter()
        row[name] = fn()
        log(f"# distributed: {name} part in {time.perf_counter() - t0:.1f} s")
    PHASE_RESULTS["distributed"] = row


def _tp_run(device, batch_raw, draws, layout):
    """TRAIN_PARITY_STEPS fp32 stage-2 steps through the Trainer (placed on
    ``layout`` when given): the losses, step 1's whole gradients, ms a
    step (steps 2-3, synchronised) and the Trainer."""
    model = Convofusion(without_dropout(PRODUCTION), dtype="float32",
                        device=device, seed=0)
    batch = train_batch(model, batch_raw)
    trainer = Trainer(model, mesh=layout)
    trainer.init_state()
    losses, times, grads = [], [], None
    for step in range(TRAIN_PARITY_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        with trainer.training():
            loss, _ = trainer.compute_grads(batch, None, draws[step])
            if grads is None:
                grads = {n: p.grad.detach().clone()
                         for n, p in zip(trainer.names, trainer.params)
                         if p.grad is not None}
            trainer.apply_grads()
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    if layout is not None:
        axis = tp_lib.model_axis(model)
        grads = {n: tp_lib.full_tensor(g, model.tp_placements[n][1], axis)
                 for n, g in grads.items()}
    return losses, {n: g.cpu() for n, g in grads.items()}, \
        statistics.median(times[1:]) * 1e3, model


def tp_step(smi, device="cuda"):
    """One production stage-2 step (and 3 AdamW steps) through the Trainer
    with a (1, 1) ('data', 'model') mesh and the tensor-parallel placement
    under a world-size-1 group (NCCL on the card) against the plain
    Trainer: phase 11's bounds."""
    b = TRAIN_PARITY_BATCH
    raw = synthetic_raw_batch(191, b, mel_frames=PRODUCTION["mel_frames"])
    draws = train_draws(np.random.default_rng(192), "diffusion", b,
                        TRAIN_PARITY_STEPS, PRODUCTION["latent_dim"][1])
    l_plain, g_plain, ms_plain, _ = _tp_run(device, raw, draws, None)
    with torchrun_env():
        dev = dist_mesh.init_distributed({"TPU": {"MULTIHOST": True}},
                                         "cpu" if device == "cpu" else None)
        try:
            layout = dist_mesh.create_mesh(1, 1)
            l_tp, g_tp, ms_tp, model = _tp_run(dev, raw, draws, layout)
            counts = tp_lib.describe_tp(model, layout)
            backend = torch.distributed.get_backend()
            del model
        finally:
            dist_mesh.shutdown()
    d_loss = abs(l_tp[0] - l_plain[0]) / abs(l_plain[0])
    worst, worst_name = _grad_worst(g_tp, g_plain)
    d_fit = max(abs(a - c) / abs(c) for a, c in zip(l_tp, l_plain))
    log(f"# tools: TP stage-2 step, production fp32 batch {b}, "
        f"create_mesh(1, 1) + apply_tp under a world-size-1 {backend} group "
        f"on {smi}: {counts['sharded']} tensors split "
        f"({counts['sharded_elements']} elements), {counts['replicated']} "
        f"replicated ({counts['replicated_elements']}); step-1 loss "
        f"{l_plain[0]:.6g}, relative gap {d_loss:.3g} (tolerance "
        f"{TRAIN_LOSS_RTOL}); {len(g_plain)} gradients, the worst at "
        f"{worst:.3g} of its tolerance ({worst_name}); {TRAIN_PARITY_STEPS} "
        f"losses {[round(x, 6) for x in l_tp]} against "
        f"{[round(x, 6) for x in l_plain]}, relative gap {d_fit:.3g}; "
        f"{ms_tp:.2f} ms a step against {ms_plain:.2f} ms plain")
    log("# tools: one card holds one NCCL rank: the 2-rank (1, 2) and "
        "4-rank (2, 2) / (1, 4) TP steps are proven with gloo on the CPU "
        "(tests/test_torch_tp.py, tests/test_torch_tp_mesh.py)")
    if set(g_tp) != set(g_plain) or not d_loss <= TRAIN_LOSS_RTOL or \
            not worst <= 1.0 or not d_fit <= TRAIN_FIT_RTOL or \
            not all(np.isfinite(l_tp)) or counts["sharded"] == 0:
        raise RuntimeError(f"tools: the TP step differs from the plain "
                           f"step (loss {d_loss}, gradient {worst_name} at "
                           f"{worst}, losses {d_fit})")
    return {"ms_tp": ms_tp, "ms_plain": ms_plain, "counts": counts}


def bvh_conversion(smi, device="cuda"):
    """BVH_FILES BEAT-skeleton takes of BVH_FRAMES frames through
    convert_speaker on the card and on the CPU: joint positions within
    BVH_ATOL, the float64 kinematics within FK_ATOL; ms a file split into
    parse and FK."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bvh") as tmp:
        spk = os.path.join(tmp, "beat", "2")
        os.makedirs(spk)
        paths = [synthetic.write_beat_bvh(os.path.join(spk, f"take{i}.bvh"),
                                          BVH_FRAMES, seed=i)
                 for i in range(BVH_FILES)]
        sides = {"card": device, "host": "cpu"}
        seconds, fk = {}, {}
        for side, dev in sides.items():
            t0 = time.perf_counter()
            n = beat_getjoints.convert_speaker(spk, os.path.join(tmp, side),
                                               dev)
            seconds[side] = time.perf_counter() - t0
            if n != BVH_FILES:
                raise RuntimeError(f"tools: {side} converted {n} files")
        gap = max(float(np.abs(
            np.load(os.path.join(tmp, "card", f"take{i}.npy"))
            - np.load(os.path.join(tmp, "host", f"take{i}.npy"))).max())
            for i in range(BVH_FILES))
        shape = np.load(os.path.join(tmp, "card", "take0.npy")).shape
        t0 = time.perf_counter()
        data = bvh_lib.parse_bvh(paths[0])
        parse_ms = (time.perf_counter() - t0) * 1e3
        for side, dev in sides.items():
            _sync(dev)
            t0 = time.perf_counter()
            pos, _ = bvh_lib.world_positions(data, dev)
            _sync(dev)
            fk[side] = ((time.perf_counter() - t0) * 1e3, pos.cpu())
    fk_gap = float((fk["card"][1] - fk["host"][1]).abs().max())
    log(f"# tools: BVH {BVH_FILES} takes x {BVH_FRAMES} frames "
        f"({len(data.joints)} joints, {data.frames.shape[1]} channels) -> "
        f"{shape} float32 each: convert_speaker {seconds['card']:.2f} s on "
        f"{smi}, {seconds['host']:.2f} s on the CPU; max|gap| {gap:.3g} (tol "
        f"{BVH_ATOL}); float64 FK max|gap| {fk_gap:.3g} (tol {FK_ATOL}); a "
        f"file: parse {parse_ms:.1f} ms, FK {fk['card'][0]:.1f} ms on the "
        f"card, {fk['host'][0]:.1f} ms on the CPU")
    if not gap <= BVH_ATOL or not fk_gap <= FK_ATOL:
        raise RuntimeError(f"tools: the card's BVH conversion differs "
                           f"({gap}, FK {fk_gap})")
    return {"convert_s": seconds["card"], "convert_cpu_s": seconds["host"],
            "parse_ms": parse_ms, "fk_ms": fk["card"][0],
            "fk_cpu_ms": fk["host"][0]}


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def utterance_sets(smi, device="cuda"):
    """A SESSION_SECONDS 5-person session through process_session (silence
    scans on the device) on the card and on the CPU: the same set
    directories, every .npy / .wav / .txt byte-equal."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_utt") as tmp:
        sess = synthetic.write_session(os.path.join(tmp, "sessions", "g1"),
                                       SESSION_SECONDS, seed=11)
        sets, secs, trees = {}, {}, {}
        for side, dev in (("card", device), ("host", "cpu")):
            out = os.path.join(tmp, side)
            t0 = time.perf_counter()
            sets[side] = process_session(sess, out,
                                         transcriber=NullTranscriber(),
                                         device=dev)
            secs[side] = time.perf_counter() - t0
            trees[side] = _tree_bytes(out)
    same = trees["card"] == trees["host"]
    kinds = sorted({os.path.splitext(k)[1] for k in trees["card"]})
    log(f"# tools: utterance sets from a {SESSION_SECONDS} s 5-person "
        f"session: {sets['card']} sets ({len(trees['card'])} files {kinds}) "
        f"in {secs['card'] * 1e3:.1f} ms on {smi}, {sets['host']} in "
        f"{secs['host'] * 1e3:.1f} ms on the CPU; every file byte-equal: "
        f"{same}")
    if not same or not sets["card"] or kinds != [".npy", ".txt", ".wav"]:
        raise RuntimeError("tools: the card's utterance sets differ from "
                           "the CPU's")
    return {"sets": sets["card"], "ms": secs["card"] * 1e3,
            "cpu_ms": secs["host"] * 1e3}


def asset_manifest():
    """freeze, then verify with one file changed and one added: 'changed'
    and 'untracked', and the --verify CLI exits 1."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_assets") as tmp, \
            asset_root(tmp):
        os.makedirs(os.path.join(tmp, "t5-base"))
        for rel, data in (("t5-base/spiece.model", b"spiece"),
                          ("eval/last_499.bin", b"\x00" * 4096)):
            os.makedirs(os.path.dirname(os.path.join(tmp, rel)),
                        exist_ok=True)
            with open(os.path.join(tmp, rel), "wb") as f:
                f.write(data)
        frozen = assets_lib.freeze()
        with open(os.path.join(tmp, "t5-base", "spiece.model"), "wb") as f:
            f.write(b"spiecf")
        with open(os.path.join(tmp, "stray.txt"), "w") as f:
            f.write("x")
        verdict = assets_lib.verify()
        with contextlib.redirect_stdout(io.StringIO()):
            code = assets_lib.main(["--verify"])
    log(f"# tools: asset manifest: froze {len(frozen)} files; verify "
        f"{verdict}; --verify exit {code}")
    if verdict != {"t5-base/spiece.model": "changed",
                   "eval/last_499.bin": "ok", "stray.txt": "untracked"} \
            or code != 1:
        raise RuntimeError("tools: the asset manifest's verdict is wrong")
    return {"verify_exit": code}


def phase_tools(smi, device="cuda"):
    """Phase 19: tensor parallelism and the host tools."""
    row = {}
    for name, fn in (("tp_step", lambda: tp_step(smi, device)),
                     ("bvh", lambda: bvh_conversion(smi, device)),
                     ("utterance_sets", lambda: utterance_sets(smi, device)),
                     ("assets", asset_manifest)):
        t0 = time.perf_counter()
        row[name] = fn()
        log(f"# tools: {name} part in {time.perf_counter() - t0:.1f} s")
    PHASE_RESULTS["tools"] = row


def phase_main(smi):
    model = Convofusion(PRODUCTION, dtype="bfloat16", seed=1)
    raw = synthetic_raw_batch(21, BATCH, mel_frames=PRODUCTION["mel_frames"])
    batch, _, _ = prepare_arrays(model, raw)
    gen = torch.Generator(device=model.device).manual_seed(22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    COUNTS["guided_step.launches"] = 0
    captures = COUNTS["denoiser.graph_captures"]
    plain = COUNTS["cross_attend.plain"]
    # the guided cross-attention kernel: once a (layer, stream) in the
    # capture's eager warm-up and once in the capture, never in a replay
    cores = len(model.denoiser.decoder.layers) * len(COND_STREAMS)
    cross = []
    # the guided LayerNorm kernel: 15 norms a layer and the final one, each
    # once in the capture's warm-up and once in the capture
    ln_plain = COUNTS["layer_norm.plain"]
    norms = 15 * len(model.denoiser.decoder.layers) + 1
    ln = []
    times = []
    for call in range(1 + TIMED_CALLS):
        before = COUNTS["guided_step.launches"]
        replays = COUNTS["denoiser.graph_replays"]
        cross_before = COUNTS["cross_attend.launches"]
        ln_before = COUNTS["layer_norm.launches"]
        t0 = time.perf_counter()
        motion, latents = model.sample(batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if COUNTS["guided_step.launches"] - before != STEPS:
            raise RuntimeError(
                f"call {call}: {COUNTS['guided_step.launches'] - before} "
                f"kernel launches, want {STEPS}")
        if COUNTS["denoiser.graph_replays"] - replays != STEPS:
            raise RuntimeError(
                f"call {call}: {COUNTS['denoiser.graph_replays'] - replays}"
                f" guided graph replays, want {STEPS}")
        cross.append(COUNTS["cross_attend.launches"] - cross_before)
        if cross[-1] != (0 if call else 2 * cores):
            raise RuntimeError(
                f"call {call}: {cross[-1]} cross_attend launches, want "
                f"{0 if call else 2 * cores}")
        ln.append(COUNTS["layer_norm.launches"] - ln_before)
        if ln[-1] != (0 if call else 2 * norms):
            raise RuntimeError(
                f"call {call}: {ln[-1]} layer_norm launches, want "
                f"{0 if call else 2 * norms}")
        if tuple(motion.shape) != (BATCH, 128, 189) or \
                not torch.isfinite(motion).all() or \
                not torch.isfinite(latents).all():
            raise RuntimeError(f"main path motion {tuple(motion.shape)} "
                               f"misshapen or not finite")
        if call:
            times.append(dt)
        log(f"# main: call {call} {'(warm-up) ' if not call else ''}"
            f"{dt * 1e3:.1f} ms")
    launches = COUNTS["guided_step.launches"]
    if COUNTS["cross_attend.plain"] != plain:
        raise RuntimeError(f"{COUNTS['cross_attend.plain'] - plain} guided "
                           f"cross-attentions took the plain version")
    PHASE_RESULTS["cross_attend_main"] = {"by_call": cross, "plain": 0}
    log(f"# main: cross_attend launches by call {cross} ({cores} a capture's"
        f" warm-up and {cores} in the capture, none a replay), 0 plain")
    if COUNTS["layer_norm.plain"] != ln_plain:
        raise RuntimeError(f"{COUNTS['layer_norm.plain'] - ln_plain} guided "
                           f"LayerNorms took the plain version")
    PHASE_RESULTS["layer_norm_main"] = {"by_call": ln, "plain": 0}
    log(f"# main: layer_norm launches by call {ln} ({norms} a capture's "
        f"warm-up and {norms} in the capture, none a replay), 0 plain")
    if COUNTS["denoiser.graph_captures"] - captures != 1:
        raise RuntimeError(
            f"{COUNTS['denoiser.graph_captures'] - captures} guided graph "
            f"captures over {1 + TIMED_CALLS} calls at one geometry, want 1")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"# main: bf16 batch {BATCH} DDIM-{STEPS} 7-way guidance on {smi}: "
        f"{BATCH / med:.2f} clips/s, {med * 1e3:.1f} ms/call (median of "
        f"{TIMED_CALLS}), peak memory {peak / 2**30:.2f} GiB, "
        f"{launches} kernel launches over {1 + TIMED_CALLS} calls, "
        f"|motion| <= {float(motion.float().abs().max()):.3g}")
    graph_against_eager(model)

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


@contextlib.contextmanager
def eager_graphs():
    """Nothing captured inside the block: every guided denoiser call and
    every training step eager, as before the CUDA graphs."""
    devices = cuda_graphs.CAPTURE_DEVICES
    cuda_graphs.CAPTURE_DEVICES = ()
    try:
        yield
    finally:
        cuda_graphs.CAPTURE_DEVICES = devices


def graph_against_eager(model):
    """sample() with the guided denoiser replayed from its graph against
    the eager loop, from one noise, at each of GRAPH_BATCHES: bit-equal
    motion and latents, 50 replays and 50 kernel launches a graphed call,
    none and 50 an eager one, and the wall time of each."""
    for b in GRAPH_BATCHES:
        raw = synthetic_raw_batch(23 + b, b,
                                  mel_frames=PRODUCTION["mel_frames"])
        batch, _, _ = prepare_arrays(model, raw)
        gen = torch.Generator(device=model.device).manual_seed(24)
        shape = (b, model.latent_tokens, model.latent_dim)
        init = torch.randn(shape, generator=gen, device=model.device)
        steps = torch.randn((STEPS,) + shape, generator=gen,
                            device=model.device)
        out, ms = {}, {}
        for name in ("graphed", "eager", "graphed"):
            launches = COUNTS["guided_step.launches"]
            replays = COUNTS["denoiser.graph_replays"]
            with eager_graphs() if name == "eager" else \
                    contextlib.nullcontext():
                t0 = time.perf_counter()
                out[name] = model.sample(batch, init_noise=init,
                                         step_noise=steps)
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
            counts = (COUNTS["denoiser.graph_replays"] - replays,
                      COUNTS["guided_step.launches"] - launches)
            want = (0 if name == "eager" else STEPS, STEPS)
            if counts != want:
                raise RuntimeError(f"graph check, batch {b}, {name}: "
                                   f"(replays, launches) {counts}, want "
                                   f"{want}")
        gaps = [float((g.float() - e.float()).abs().max())
                for g, e in zip(out["graphed"], out["eager"])]
        log(f"# main: batch {b} graphed against eager guided loop: max "
            f"|diff| motion {gaps[0]:.3g}, latents {gaps[1]:.3g}; "
            f"{ms['graphed']:.1f} ms graphed (the second call), "
            f"{ms['eager']:.1f} ms eager")
        if any(gaps):
            raise RuntimeError(f"batch {b}: the graphed sampler is not "
                               f"bit-equal to the eager one: {gaps}")


def _union_ms(events) -> float:
    """Milliseconds in which some kernel, copy or memset of ``events``
    runs (not the spans' device-side ranges)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


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


PHASES = {4: "parity", 5: "main", 6: "weg_parity", 7: "serve",
          8: "rollout_parity", 9: "rollout", 10: "dpmpp",
          11: "train_parity", 12: "train", 13: "checkpoint", 14: "test_cli",
          15: "train_cli", 16: "variants", 17: "ablations",
          18: "distributed", 19: "tools"}
# the phases whose runs launch the step kernel (the others must not)
PATH_PHASES = {5, 6, 7, 8, 9, 13, 14, 15, 16, 17, 18}


def parse_phases(spec: str):
    """'1-3,13' -> {1, 2, 3, 13}; phases 1-3 always run."""
    chosen = {1, 2, 3}
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        chosen.update(range(int(lo), int(hi or lo) + 1))
    unknown = chosen - {1, 2, 3} - set(PHASES)
    if unknown:
        raise ValueError(f"no phase {sorted(unknown)}")
    if not chosen & PATH_PHASES:
        raise ValueError(f"choose at least one phase of {sorted(PATH_PHASES)}"
                         f": the JSON line counts the main path's launches")
    return chosen


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default="1-19", type=parse_phases,
                    help="e.g. '1-3,13' (default every phase; 1-3 always "
                         "run)")
    chosen = ap.parse_args(argv).phases
    t_run = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows, max_err, checked = phase_kernel()
    t0 = time.perf_counter()
    cross, cross_checked = phase_cross_attend(
        torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    log(f"# phase 3 cross_attend: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    norms, ln_checked = phase_layer_norm(
        torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    log(f"# phase 3 layer_norm: {time.perf_counter() - t0:.1f} s")
    plain_calls = record_plain_calls()
    ln_plain_calls = record_ln_plain_calls()
    in_path_us = None

    def run_main():
        nonlocal in_path_us
        launches, in_path_us = phase_main(smi)
        return launches

    def run_dpmpp():
        dpmpp_case = phase_dpmpp(smi)
        launches = COUNTS["guided_step.launches"]
        dpmpp_against_ddim(*dpmpp_case)
        return launches

    # a phase that returns its count returns what its path launched before
    # its extra measurements (profiles, comparisons); otherwise the count
    # is read after it
    runs = {4: phase_parity, 5: run_main, 6: phase_weg_parity,
            7: lambda: phase_serve(smi), 8: phase_rollout_parity,
            9: lambda: phase_rollout(smi), 10: run_dpmpp,
            11: phase_train_parity,
            12: lambda: PHASE_RESULTS.setdefault("train", phase_train(smi)),
            13: lambda: phase_checkpoint(smi),
            14: lambda: phase_test_cli(smi),
            15: lambda: phase_train_cli(smi),
            16: lambda: phase_variants(smi),
            17: lambda: phase_ablations(smi),
            18: lambda: phase_distributed(smi),
            19: lambda: phase_tools(smi)}
    by_phase, cross_by_phase, ln_by_phase = {}, {}, {}
    for number in sorted(chosen - {1, 2, 3}):
        COUNTS["guided_step.launches"] = 0
        name = PHASES[number]
        cross_before = (COUNTS["cross_attend.launches"],
                        COUNTS["cross_attend.plain"], len(plain_calls))
        ln_before = (COUNTS["layer_norm.launches"],
                     COUNTS["layer_norm.plain"], len(ln_plain_calls))
        t0 = time.perf_counter()
        launches = runs[number]()
        log(f"# phase {number} {name}: {time.perf_counter() - t0:.1f} s")
        # the guided cross-attention kernel: its launches and the on-card
        # calls that took the plain version; a bf16 one never may
        plain = plain_calls[cross_before[2]:]
        cross_by_phase[name] = dict(
            launches=COUNTS["cross_attend.launches"] - cross_before[0],
            plain=COUNTS["cross_attend.plain"] - cross_before[1],
            plain_bf16=sum(d == torch.bfloat16 for d, _ in plain))
        if cross_by_phase[name]["plain_bf16"]:
            raise RuntimeError(
                f"{name}: {cross_by_phase[name]['plain_bf16']} bf16 guided "
                f"cross-attentions on the card took the plain version "
                f"({sorted({r for d, r in plain if d == torch.bfloat16})})")
        # the guided LayerNorm kernel likewise: a bf16 norm without grad
        # never takes the plain version
        plain = ln_plain_calls[ln_before[2]:]
        ln_by_phase[name] = dict(
            launches=COUNTS["layer_norm.launches"] - ln_before[0],
            plain=COUNTS["layer_norm.plain"] - ln_before[1],
            plain_bf16_no_grad=sum(d == torch.bfloat16 and not g
                                   for d, g, _ in plain))
        if ln_by_phase[name]["plain_bf16_no_grad"]:
            raise RuntimeError(
                f"{name}: {ln_by_phase[name]['plain_bf16_no_grad']} bf16 "
                f"guided LayerNorms on the card without grad took the plain "
                f"version ({sorted({r for d, g, r in plain if not g})})")
        if number == 4:
            continue       # a parity check, not the main path
        by_phase[name] = (launches if isinstance(launches, int)
                          else COUNTS["guided_step.launches"])
        if number not in PATH_PHASES and by_phase[name]:
            raise RuntimeError(f"{name} launched the step kernel "
                               f"{by_phase[name]} times")
    if not sum(by_phase.values()):
        raise RuntimeError("the main path never launched the step kernel")
    # the kernel against its plain version at every shape the path gave it
    # that phase 3 did not hold it at
    unchecked = gs_mod.guided_step.shapes - checked
    if unchecked:
        err = kernel_at_shapes(unchecked)
        max_err = max(max_err, err)
        log(f"# kernel guided_step at the path's other shapes "
            f"{sorted(unchecked, key=str)}: max|diff| {err:.3g}")
    log(f"# cross_attend by phase (launches, on-card plain calls, bf16 "
        f"among them): {cross_by_phase}")
    # the cross-attention kernel likewise, at every geometry the path gave
    # it that phase 3 did not hold it at
    cross_unchecked = ca_mod.cross_attend.shapes - cross_checked
    cross_path = cross_at_geometries(cross_unchecked)
    log(f"# kernel cross_attend at the path's other geometries "
        f"{sorted(cross_unchecked)} (B, Tq, Tk real, Tk uncond, uncond "
        f"batch, mask batches, real branches): "
        + "; ".join(f"{k}: rel RMS {v['rel']:.3g}, {v['differ']:.2%} differ,"
                    f" {v['ulps']} ulps away from 0"
                    for k, v in sorted(cross_path.items())))

    log(f"# layer_norm by phase (launches, on-card plain calls, bf16 "
        f"without grad among them): {ln_by_phase}")
    # and the LayerNorm kernel at every geometry the path gave it that
    # phase 3 did not hold it at
    ln_unchecked = ln_mod.layer_norm.shapes - ln_checked
    ln_path = dict(ulps=0, differ=0.0)
    for i, geom in enumerate(sorted(ln_unchecked, key=str)):
        gap = ln_check(geom, 71 + i)
        ln_path = {k: max(ln_path[k], gap[k]) for k in ln_path}
    log(f"# kernel layer_norm at the path's other geometries "
        f"{sorted(ln_unchecked, key=str)} (rows, width, input dtype, "
        f"epilogue (rows a batch row, batch rows)): at most "
        f"{ln_path['ulps']} bf16 "
        f"ulps, {ln_path['differ']:.4%} of elements differ")

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
        # every shape phase 3 timed: (7, 96, 16, 128) of the latent paths
        # and (7, 96, 128, 189) of raw motion, each case and plane dtype
        "shapes": [{"case": key, **row} for key, row in sorted(rows.items())],
        "in_path_us_raw_motion": PHASE_RESULTS.get("variants", {}).get(
            "raw_motion", {}).get("in_path_us"),
        # sample() with the kernel and with TPU.PALLAS_STEP false, in turns
        # (phase 17)
        "sample_ms_by_step_path": {
            k: v for k, v in PHASE_RESULTS.get("ablations", {}).get(
                "step_paths", {}).items() if k != "fp32_gaps"} or None,
    }, {
        "name": "cross_attend",
        "route": "cuda",
        "source": "convofusion_tpu_torch/csrc/cross_attend.cu",
        "replaces": None,
        # over the main path (phase 5): a capture's warm-up and capture,
        # then none a replay; no plain call
        "launches": PHASE_RESULTS.get("cross_attend_main"),
        # every phase: launches, on-card plain calls, bf16 among them (0)
        "launches_by_phase": cross_by_phase,
        # the worst gaps over phase 3's cases: the kernel against the plain
        # version and against the fp64 witness, the plain version against
        # the witness (relative RMS, share of elements that differ, bf16
        # ulps away from zero)
        "gaps": cross["worst"],
        "path_geometries": [list(g[:7]) + [list(g[7])]
                            for g in sorted(cross_unchecked)],
        "path_gaps": cross_path,
        "layer_ms": cross["layer"]["ms"],
        "layer_warm_ms": cross["layer"]["warm_ms"],
        "layer_plain_ms": cross["layer"]["plain_ms"],
        "layer_bound_ms": cross["layer"]["bound_ms"],
        "bound_by": "bytes",
        "streams": cross["streams"],
    }, {
        "name": "layer_norm",
        "route": "cuda",
        "source": "convofusion_tpu_torch/csrc/layer_norm.cu",
        "replaces": None,
        # over the main path (phase 5): a capture's warm-up and capture,
        # then none a replay; no plain call
        "launches": PHASE_RESULTS.get("layer_norm_main"),
        # every phase: launches, on-card plain calls, bf16 ones without
        # grad among them (0)
        "launches_by_phase": ln_by_phase,
        # the largest gap from the plain version over phase 3's geometries
        # and over the path's others (bf16 ulps, share of elements)
        "gaps": norms["worst"],
        "path_geometries": [[g[0], g[1], g[2] and list(g[2])]
                            for g in sorted(ln_unchecked, key=str)],
        "path_gaps": ln_path,
        "layer_ms": norms["layer"]["ms"],
        "layer_warm_ms": norms["layer"]["warm_ms"],
        "layer_plain_ms": norms["layer"]["plain_ms"],
        "layer_library_ms": norms["layer"]["library_ms"],
        "layer_bound_ms": norms["layer"]["bound_ms"],
        "bound_by": "bytes",
        "norms": norms["norms"],
    }]
    log(f"# whole run: {time.perf_counter() - t_run:.1f} s, phases "
        f"{sorted(chosen)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
