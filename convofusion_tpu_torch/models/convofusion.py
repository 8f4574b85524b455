"""Convofusion: the two training stages and guided generation.

Port of ``convofusion_tpu/models/convofusion.py``: the training losses
(:262-567: ``encode_vae_posterior``, ``train_vae_loss``,
``train_vae_diffusion_loss``, ``encode_text_trunk``, ``project_trunk``,
``encode_conditions_precomputed``, the 6-group modality dropout,
``train_diffusion_loss``), ``encode_text``, ``encode_conditions``,
``encode_uncond``, ``diffusion_reverse``, ``sample`` (:330-383,604-943),
with word-excitation guidance (WEG), the long-form rollout's ``preseq``
inpainting and the DPM-Solver++ 2M sampler, and ``cached_sampler`` /
``CachedSampler`` / ``gen_from_latent`` (:945-1038).
Weights live in the modules; ``compat/from_jax.state_dict_from_jax``
carries a JAX parameter tree across.

A training loss draws its randomness (the VAE's reparameterisation noise,
the modality-dropout groups, the diffusion noise and timesteps) on the
model's device from a ``torch.Generator``, or takes each from ``draws``;
dropout masks come from the same generator (``ops/layers.dropout_generator``
scopes it around the loss), so a step repeats from its generator's state.
A step reads nothing back to the host.

Per ``sample()``: the conditions are encoded once (T5 x2, the mel MLP and
the fuser; the uncond branch at batch 1), then each of the N reverse steps
is one 7-branch ``Denoiser.guided`` call followed by one launch of the
fused guidance + scheduler step kernel (``ops/guided_step.py``), then the
VAE decodes (B, 16, D) latents to (B, 128, 189) motion.  On the card the
guided call is one replay of its CUDA graph, captured once per input
geometry (``models/denoiser.GuidedGraphs``); the step kernel, whose
coefficients change every step, is launched eagerly after it.  With WEG,
each step first differentiates a text-only denoiser pass w.r.t. the
latents and moves them (``models/weg.py``); the step kernel is not
differentiated.
With ``preseq`` each step first overwrites the leading latent tokens with
the previous window's, re-noised to the step's level.  DPM-Solver++ takes
the plain guidance combine and its own update instead of the kernel, as
JAX's gate does.  With ``guidance_scale`` <= 1 a step is one denoiser call on
the real conditions and the plain update, again without the kernel.  The
fused-stream denoiser (``fuse_streams``) has no guided path: a step tiles
the latents over the seven branches' assembled conditions (7B rows), one
plain forward, and the plain combine and update, without the kernel (JAX
:640-649, :828-840).

``TPU.PALLAS_STEP`` false (``cfg['pallas_step']``, JAX :175-177) takes the
plain combine and ``scheduler.step`` in place of the kernel on every
device.  The trans_enc denoiser (``cfg['denoiser']['arch']``) trains and
samples unguided; guided sampling with it raises before any work, as JAX
fails there.

With ``vae_type`` 'no' (JAX :84-110) there is no VAE: the diffusion runs
on raw motion, (B, max_len, nfeats) latents, encode and decode are the
identity, and guided DDIM/DDPM steps launch the kernel on (7, B, 128, 189)
planes.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from convofusion_tpu_torch import resolve_device, resolve_dtype
from convofusion_tpu_torch.diffusion.schedulers import scheduler_from_config
from convofusion_tpu_torch.losses.diffvae import (
    bone_pairs,
    channel_weights,
    diffusion_losses,
    vae_losses,
)
from convofusion_tpu_torch.models import weg as weg_lib
from convofusion_tpu_torch.models.audioenc import AudioConvEncoder
from convofusion_tpu_torch.models.condfuser import TextAudioMotionFuser
from convofusion_tpu_torch.models.denoiser import (
    ONE_TENSOR_CONDITIONS,
    Denoiser,
    GuidedGraphs,
)
from convofusion_tpu_torch.models.t5 import T5TextEncoder
from convofusion_tpu_torch.models.tokenizer import (
    UNCOND_TEXT,
    WordHashTokenizer,
    make_tokenizer,
)
from convofusion_tpu_torch.models.vae import (
    BODY_NFEATS,
    HANDS_NFEATS,
    ConvoFusionVae,
)
from convofusion_tpu_torch.ops import cross_attend, layer_norm
from convofusion_tpu_torch.ops.guided_step import guided_step
from convofusion_tpu_torch.ops.layers import (
    default_init,
    dropout_generator,
    init_weights,
)
from convofusion_tpu_torch.ops.smoothing import (
    laplace_filter_time,
    laplacian_1d_kernel,
)
from convofusion_tpu_torch.ops.transformer import (
    COND_STREAMS,
    GUIDANCE_BRANCHES,
    NUM_BRANCHES,
)
from convofusion_tpu_torch.parallel import mesh
from convofusion_tpu_torch.utils import profiling

STAGES = ("vae", "diffusion", "vae_diffusion")
# modality-dropout groups a training batch is cut into, besides the rows
# that keep every condition (convofusion_tpu/models/convofusion.py:75)
CLF_GUIDANCE_DROPS = 6
# t5-base's embedding rows: the vocab that takes the real tokenizer
T5_VOCAB_SIZE = 32128


def to_tensors(arrays: Dict[str, np.ndarray], device) -> Dict:
    """numpy batch -> tensors on ``device``: integer arrays become int64
    indices, bool masks stay bool, floats stay fp32.  To the card the
    copies go from pinned memory without blocking the host."""
    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


@contextlib.contextmanager
def _eval(module: nn.Module):
    """``module`` in eval mode inside the block, as it was after."""
    was = module.training
    if was:
        module.eval()
    try:
        yield
    finally:
        if was:
            module.train()


def vae_posterior(vae: nn.Module, motion: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vae``'s (mu, logvar) of ``motion`` in eval mode with no grad,
    batch-leading: (B, 2, n_chunks, D) each."""
    with torch.no_grad(), _eval(vae):
        _, (mu, logvar), _ = vae.encode(motion)
    return (mu.transpose(0, 1).contiguous(),
            logvar.transpose(0, 1).contiguous())


def _draw(draws: Optional[Dict], name: str, make, device, axis: int = 0):
    """``draws[name]`` (a tensor or an array) moved to ``device`` if
    given, else ``make(k)`` with the batch axis ``axis`` k times this
    rank's batch.  Under k data ranks that draws the global batch's values
    and keeps this rank's rows (``parallel/mesh.local_rows``), as JAX draws
    over the global batch."""
    if draws is not None and name in draws:
        value = draws[name]
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.array(value))
        return value.to(device)
    world = mesh.data_size()
    return mesh.local_rows(make(world), axis) if world > 1 else make(1)


def _masks_from_generator(loss):
    """A training loss whose ``Dropout`` masks draw from its ``generator``
    argument (JAX splits the dropout key off the step's key,
    convofusion_tpu/models/convofusion.py:288-291,501-507); under several
    data ranks, from the data rank's own stream
    (``parallel/mesh.mask_generator``)."""

    @functools.wraps(loss)
    def wrapped(self, batch, generator=None, draws=None):
        with dropout_generator(mesh.mask_generator(generator, self.device)):
            return loss(self, batch, generator, draws)

    return wrapped


def uncond_melspec(shape, dtype=torch.float32, device=None):
    """-90 dB everywhere except mel bins 40:45 (reference
    convofusion.py:214-216)."""
    mel = torch.full(shape, -90.0, dtype=dtype, device=device)
    mel[..., 40:45] = 0.0
    return mel


@dataclass
class WegCounts:
    """What the WEG path ran, summed over ``sample()`` calls: text-only
    denoiser passes (each a forward and a backward), refinement-loop
    iterations, and reverse steps whose refinement triggered."""
    text_only_passes: int = 0
    refinement_iterations: int = 0
    refined_steps: int = 0


class Convofusion(nn.Module):
    """The model of a training stage, and of generation.

    ``cfg`` is a dict shaped like ``config.PRODUCTION``; ``dtype`` the
    compute dtype of every module ('float32' or 'bfloat16'); ``device``
    None means the card (raises without one); ``seed`` seeds the weight
    init (None keeps PyTorch's default init, for weights loaded after);
    ``stage`` 'vae' builds the motion VAE alone (stage 1), 'diffusion'
    (the default, stage 2, and generation) and 'vae_diffusion' build the
    whole model (convofusion_tpu/models/convofusion.py:142).

    The tokenizer, as JAX picks it (:120-139): ``tokenizer`` if given; the
    word-hash tokenizer for a vocab other than t5-base's 32128 (real t5
    ids would fall outside a smaller embedding); otherwise
    ``make_tokenizer(cfg['t5_path'])``, the exact t5-base tokenizer where a
    ``spiece.model`` is on disk, the word-hash one with a warning where
    none is."""

    def __init__(self, cfg: Dict, dtype="float32", device=None,
                 seed: Optional[int] = 0, stage: str = "diffusion",
                 tokenizer=None):
        super().__init__()
        if stage not in STAGES:
            raise ValueError(f"stage {stage!r}, not one of {STAGES}")
        self.cfg = cfg
        self.stage = stage
        dtype = resolve_dtype(dtype)
        device = resolve_device(device)
        self.latent_size, self.latent_dim = (int(v) for v in cfg["latent_dim"])
        self.max_len = int(cfg["max_len"])
        self.n_chunks = self.max_len // 16
        self.latent_tokens = 2 * self.n_chunks
        self.vae_type = str(cfg.get("vae_type", "convofusion"))
        if self.vae_type == "no":
            # the identity latent space (JAX :98-102): z is the motion
            self.latent_tokens = self.max_len
            self.latent_dim = int(cfg["nfeats"])
        self.text_pad_len = int(cfg["text_pad_len"])
        self.guidance_scale = float(cfg["guidance_scale"])
        self.do_classifier_free_guidance = self.guidance_scale > 1.0
        self.predict_epsilon = bool(cfg["predict_epsilon"])
        if int(cfg["nfeats"]) != BODY_NFEATS + HANDS_NFEATS:
            raise ValueError(f"nfeats {cfg['nfeats']}: the VAE decodes "
                             f"{BODY_NFEATS} + {HANDS_NFEATS} features")
        te = cfg["text_encoder"]
        vocab_size = int(te["vocab_size"])
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif vocab_size != T5_VOCAB_SIZE:
            self.tokenizer = WordHashTokenizer(vocab_size=vocab_size,
                                               max_length=self.text_pad_len)
        else:
            self.tokenizer = make_tokenizer(
                str(cfg.get("t5_path", "t5-base")),
                max_length=self.text_pad_len, vocab_size=vocab_size)
        # a seeded model skips the default init its init_weights replaces
        with default_init(seed is None):
            self._build_modules(cfg, stage, dtype)
        # TPU.PALLAS_STEP: false takes the plain combine and update on every
        # device (JAX :175-177, :640-649)
        self.use_step_kernel = bool(cfg.get("pallas_step", True))
        # TPU.SCAN_UNROLL: JAX's scan unroll factor, which changes no
        # number (:181-182, :855); an eager loop has nothing to unroll
        self.scan_unroll = int(cfg.get("scan_unroll", 1))
        train = cfg.get("train", {})
        self.guidance_uncondp = float(cfg.get("guidance_uncondp", 0.0))
        self.loss_weights = dict(train.get("loss", {}))
        laplace_size = (0 if self.vae is None
                        else int(train.get("laplace_kernel_size", 0)))
        bones = train.get("bones")
        # the losses' constant tables, kept on the model's device
        self.register_buffer(
            "_bone_pairs", None if bones is None
            else torch.from_numpy(bone_pairs(bones)), persistent=False)
        self.register_buffer("_channel_weights", torch.from_numpy(
            channel_weights(int(cfg["nfeats"]))), persistent=False)
        self.register_buffer(
            "_laplace_kernel", None if laplace_size == 0
            else torch.from_numpy(laplacian_1d_kernel(laplace_size)),
            persistent=False)
        # [group, stream]: is the stream real in guidance branch `group`
        self.register_buffer("_keep_table", torch.tensor(
            [[s in GUIDANCE_BRANCHES[g] for s in COND_STREAMS]
             for g in range(NUM_BRANCHES)]), persistent=False)
        self.weg_parameters = cfg.get("weg_parameters", {})
        self.weg_counts = WegCounts()
        # bumped by load_state_dict and by a move or cast of the weights:
        # CachedSampler drops its uncond encodes, and the guided denoiser
        # its graphs
        self.weights_version = 0
        self.guided_graphs = GuidedGraphs()
        if seed is not None:
            init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()
        if device.type == "cuda" and stage != "vae" and \
                self.do_classifier_free_guidance:
            # the guided cross-attention and LayerNorm kernels' compiles
            # overlap the weights' load and the rest of the set-up
            cross_attend.start_build()
            layer_norm.start_build()
        # generation only: WEG differentiates w.r.t. the latents alone
        self.requires_grad_(False)

    def _build_modules(self, cfg: Dict, stage: str, dtype) -> None:
        """The stage's modules: the motion VAE, and beyond stage 1 the T5
        encoder, the audio encoder, the fuser, the denoiser and the two
        schedulers."""
        d = int(cfg["denoiser"]["text_encoded_dim"])
        self.vae = None if self.vae_type == "no" else ConvoFusionVae(
            latent_dim=self.latent_dim, latent_size=self.latent_size,
            **cfg["motion_vae"], dtype=dtype)
        if stage != "vae":
            den = cfg["denoiser"]
            if den.get("arch", "trans_dec") == "trans_enc" and \
                    den.get("condition") in ONE_TENSOR_CONDITIONS:
                # the pipeline feeds the five streams; JAX's trans_enc
                # takes them as one tensor and fails in init_params
                raise ValueError(
                    f"model.condition={den['condition']!r} with "
                    f"model.denoiser.params.arch='trans_enc': the pipeline "
                    f"encodes the five text+audio streams, which that "
                    f"condition cannot take (JAX fails to build it)")
            self.text_encoder = T5TextEncoder(**cfg["text_encoder"],
                                              dtype=dtype)
            self.audio_encoder = AudioConvEncoder(**cfg["audio_encoder"],
                                                  dtype=dtype)
            # the JAX model builds its fuser without a compute dtype
            # (convofusion_tpu/models/convofusion.py:146-147): its
            # embedding rows stay fp32 in a bf16 model
            self.condition_fuser = TextAudioMotionFuser(out_dim=d)
            self.denoiser = Denoiser(latent_dim=self.latent_dim,
                                     **cfg["denoiser"], dtype=dtype)
            self.scheduler = scheduler_from_config(cfg["scheduler"],
                                                   self.predict_epsilon)
            # the training scheduler: it noises training latents, and the
            # rollout re-noises its preseq with it
            self.noise_scheduler = scheduler_from_config(
                cfg["noise_scheduler"], self.predict_epsilon)
            self.num_inference_timesteps = int(
                cfg["scheduler"]["num_inference_timesteps"])

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict,
                                      assign=assign)
        self.weights_version += 1
        return out

    def _apply(self, fn, recurse=True):
        # to(), cuda(), half(), ...: the weights may take new storage
        out = super()._apply(fn, recurse)
        self.weights_version += 1
        return out

    @property
    def device(self) -> torch.device:
        return self._channel_weights.device

    @property
    def fuse_streams(self) -> bool:
        return self.stage != "vae" and self.denoiser.fuse_streams

    # ------------------------------------------------------- host-side text
    def tokenize(self, texts):
        return self.tokenizer(list(texts), pad_to=self.text_pad_len)

    def prepare_text_batch(self, texts_spk, texts_lsn):
        """Host side: strings -> static-shape numpy id (int32) / mask
        (bool) arrays, incl. the uncond rows (``to_tensors`` moves them)."""
        tb_spk = self.tokenize(texts_spk)
        tb_lsn = self.tokenize(texts_lsn)
        tb_unc = self.tokenize([UNCOND_TEXT] * len(texts_lsn))
        return {
            "spk_ids": tb_spk.input_ids, "spk_tmask": tb_spk.attention_mask,
            "lsn_ids": tb_lsn.input_ids, "lsn_tmask": tb_lsn.attention_mask,
            "uncond_ids": tb_unc.input_ids,
            "uncond_tmask": tb_unc.attention_mask,
        }, tb_spk, tb_lsn

    # ------------------------------------------------------ condition encoding
    def encode_text(self, ids, tmask):
        with profiling.span("t5.encode"):
            emb, _ = self.text_encoder(ids, tmask)
        return emb

    def encode_conditions(self, spk_ids, spk_tmask, lsn_ids, lsn_tmask,
                          melspec_lsn, apb, lsn_id):
        """Returns (cond dict, mask dict); masks are pad masks (True =
        pad) for the two text streams."""
        with profiling.span("encode_conditions"):
            tspk = self.encode_text(spk_ids, spk_tmask)
            tlsn = self.encode_text(lsn_ids, lsn_tmask)
            alsn = self.audio_encoder(melspec_lsn)
            cond = self.condition_fuser(tspk, alsn, tlsn, apb, lsn_id)
        return cond, {"spkemb": ~spk_tmask, "tlsn": ~lsn_tmask}

    def encode_uncond(self, batch):
        """Uncond-branch conditions as single (1, ...) rows that broadcast
        against the batch: every uncond row is identical (uncond token ids,
        -90 dB mel, apb = 2, lsn_id = 0)."""
        mel = batch["melspec_lsn"]
        ids, tmask = batch["uncond_ids"][:1], batch["uncond_tmask"][:1]
        return self.encode_conditions(
            ids, tmask, ids, tmask,
            uncond_melspec((1,) + tuple(mel.shape[1:]), mel.dtype,
                           mel.device),
            torch.full_like(batch["active_passive_lsn"][:1], 2),
            torch.zeros_like(batch["lsn_id"][:1]))

    def encode_text_trunk(self, ids, tmask):
        """The frozen T5 trunk alone, outside the graph: the hidden states
        before the projection, a pure function of the text that a training
        run can cache (JAX :336-355): in eval mode, so without the trunk's
        dropout."""
        trunk = self.text_encoder.text_model
        with torch.no_grad(), _eval(trunk), profiling.span("t5.encode"):
            return trunk(ids, tmask)

    def project_trunk(self, trunk):
        """The trainable ReLU + Linear head over trunk states: the tail of
        ``T5TextEncoder.forward``."""
        return self.text_encoder.projection(trunk)

    def encode_conditions_precomputed(self, spk_trunk, spk_tmask, lsn_trunk,
                                      lsn_tmask, melspec_lsn, apb, lsn_id):
        """``encode_conditions`` with the T5 trunk replaced by its cached
        states (:meth:`encode_text_trunk`); the same outputs."""
        tspk = self.project_trunk(spk_trunk)
        tlsn = self.project_trunk(lsn_trunk)
        alsn = self.audio_encoder(melspec_lsn)
        cond = self.condition_fuser(tspk, alsn, tlsn, apb, lsn_id)
        return cond, {"spkemb": ~spk_tmask, "tlsn": ~lsn_tmask}

    # ------------------------------------------------------------- training
    def _posterior_shape(self, batch_size: int, nframes: int):
        """(2, B, n_chunks, latent_size * D): the shape of mu and logvar."""
        return (2, batch_size, nframes // 16,
                self.latent_size * self.latent_dim)

    def encode_vae_posterior(self, motion) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The frozen VAE's (mu, logvar) for the cached-posterior layout,
        in eval mode with no grad, batch-leading: (B, 2, n_chunks, D) each
        (JAX :262-275)."""
        self._require_vae("encode_vae_posterior")
        return vae_posterior(self.vae, motion)

    def _require_vae(self, what: str) -> None:
        if self.vae is None:
            # JAX raises TypeError in the VAE stage (:277-284)
            raise TypeError(f"{what} needs a motion VAE (vae_type 'no' "
                            f"diffuses raw motion)")

    @_masks_from_generator
    def train_vae_loss(self, batch, generator: Optional[torch.Generator]
                       = None, draws: Optional[Dict] = None):
        """Stage-1 loss on ``batch['motion']`` (B, T, nfeats) (JAX
        :277-306).  ``draws['eps']`` replaces the reparameterisation draw.
        Returns (total, dict of the terms), 0-dim tensors."""
        self._require_vae("train_vae_loss")
        motion = batch["motion"]
        b, t, _ = motion.shape
        dev = motion.device
        eps = _draw(draws, "eps", lambda k: torch.randn(
            self._posterior_shape(k * b, t), generator=generator,
            device=dev), dev, axis=1)
        latent, (mu, logvar), _ = self.vae.encode(motion, eps=eps)
        recon = self.vae.decode(latent, t)
        lap_rst = lap_ref = None
        if self._laplace_kernel is not None:
            lap_ref = laplace_filter_time(motion, self._laplace_kernel)
            lap_rst = laplace_filter_time(recon, self._laplace_kernel)
        w = self.loss_weights
        losses = vae_losses(
            recon, motion, mu, logvar, self._channel_weights, lap_rst,
            lap_ref, pairs=self._bone_pairs,
            lambda_rec=float(w["lambda_rec"]),
            lambda_kl=float(w["lambda_kl"]),
            lambda_bl=float(w.get("lambda_bl", 0.0)))
        return losses["total"], losses

    def train_vae_diffusion_loss(self, batch, generator: Optional[
            torch.Generator] = None, draws: Optional[Dict] = None):
        """The joint stage (JAX :308-327): the VAE loss of
        ``batch['motion_lsn']`` plus the diffusion loss of the batch.
        ``draws`` holds each part's under 'vae' and 'diffusion'."""
        draws = draws or {}
        vae_total, vae_terms = self.train_vae_loss(
            {"motion": batch["motion_lsn"]}, generator, draws.get("vae"))
        diff_total, diff_terms = self.train_diffusion_loss(
            batch, generator, draws.get("diffusion"))
        losses = {**{f"vae_{k}": v for k, v in vae_terms.items()},
                  **diff_terms}
        losses["total"] = vae_total + diff_total
        return losses["total"], losses

    def _dropout_groups(self, batch_size: int,
                        generator: Optional[torch.Generator], device):
        """Each row's modality-dropout group: 6 disjoint random groups of
        ``int(uncondp * B)`` rows, the rest group 6, which keeps every
        condition (JAX :403-414)."""
        k = int(self.guidance_uncondp * batch_size)
        n = CLF_GUIDANCE_DROPS * k
        perm = torch.randperm(batch_size, generator=generator, device=device)
        group = torch.full((batch_size,), NUM_BRANCHES - 1,
                           dtype=torch.long, device=device)
        group[perm[:n]] = torch.arange(n, device=device) // max(k, 1)
        return group

    def apply_modality_dropout(self, batch, generator: Optional[
            torch.Generator] = None, draws: Optional[Dict] = None):
        """Each row keeps the conditions of its group's guidance branch and
        takes the uncond value of every other (JAX :416-462): uncond token
        ids and mask, the -90 dB mel, apb 2, listener id 0.  Works on the
        token-id layout and on the cached-trunk layout (``lsn_trunk`` /
        ``spk_trunk`` / ``uncond_trunk``); uncond rows may be one row that
        broadcasts.  ``draws['group']`` (B,) replaces the groups."""
        tmask = batch["lsn_tmask"]
        b, dev = tmask.shape[0], tmask.device
        group = _draw(draws, "group", lambda k: self._dropout_groups(
            k * b, generator, dev), dev).long()
        kept = self._keep_table[group]                  # (B, 5)
        keep = {s: kept[:, i] for i, s in enumerate(COND_STREAMS)}
        k_t, k_s = keep["tlsn"][:, None], keep["spkemb"][:, None]
        out = dict(batch)
        if "lsn_ids" in batch:
            out["lsn_ids"] = torch.where(k_t, batch["lsn_ids"],
                                         batch["uncond_ids"])
            out["spk_ids"] = torch.where(k_s, batch["spk_ids"],
                                         batch["uncond_ids"])
        out["lsn_tmask"] = torch.where(k_t, tmask, batch["uncond_tmask"])
        out["spk_tmask"] = torch.where(k_s, batch["spk_tmask"],
                                       batch["uncond_tmask"])
        mel = batch["melspec_lsn"]
        out["melspec_lsn"] = torch.where(
            keep["alsn"][:, None, None], mel,
            uncond_melspec((1,) + tuple(mel.shape[1:]), mel.dtype,
                           mel.device))
        out["active_passive_lsn"] = torch.where(
            keep["apb"][:, None], batch["active_passive_lsn"], 2)
        out["lsn_id"] = torch.where(keep["lsnemb"], batch["lsn_id"], 0)
        if "lsn_trunk" in batch:
            out["lsn_trunk"] = torch.where(k_t[..., None], batch["lsn_trunk"],
                                           batch["uncond_trunk"])
            out["spk_trunk"] = torch.where(k_s[..., None], batch["spk_trunk"],
                                           batch["uncond_trunk"])
        return out

    @_masks_from_generator
    def train_diffusion_loss(self, batch, generator: Optional[
            torch.Generator] = None, draws: Optional[Dict] = None):
        """Stage-2 loss (JAX :464-567) on a ``prepare_arrays`` batch, or on
        its cached layouts: T5 trunk states (``spk_trunk``, ``lsn_trunk``,
        a one-row ``uncond_trunk``) in place of the token ids, and the
        frozen VAE's posterior (``vae_mu``, ``vae_logvar``, from
        :meth:`encode_vae_posterior`) in place of ``motion_lsn``.  The
        frozen VAE encodes in eval mode with no grad; without a VAE the
        diffusion variables are ``motion_lsn`` itself (JAX :481-492).
        ``draws`` replaces the draws 'eps', 'group', 'noise' and
        'timesteps'.  Returns (total, dict of the terms), 0-dim tensors."""
        dev = self.device
        latent = None
        if "vae_mu" in batch:
            mu = batch["vae_mu"].transpose(0, 1)
            logvar = batch["vae_logvar"].transpose(0, 1)
            eps = _draw(draws, "eps", lambda k: torch.randn(
                (2, k * mu.shape[1]) + tuple(mu.shape[2:]),
                generator=generator, device=dev), dev, axis=1)
            latent = mu + torch.exp(0.5 * logvar) * eps
        elif self.vae is None:
            z = batch["motion_lsn"].detach().float()
        else:
            motion = batch["motion_lsn"]
            eps = _draw(draws, "eps", lambda k: torch.randn(
                self._posterior_shape(k * motion.shape[0], motion.shape[1]),
                generator=generator, device=dev), dev, axis=1)
            with torch.no_grad(), _eval(self.vae):
                latent, _, _ = self.vae.encode(motion, eps=eps)
        if latent is not None:
            # (2, B, 8, D) -> (B, 16, D), body and hands interleaved per
            # chunk
            z = latent.permute(1, 2, 0, 3).reshape(latent.shape[1], -1,
                                                   self.latent_dim)
        b = z.shape[0]

        dropped = self.apply_modality_dropout(batch, generator, draws)
        if "lsn_trunk" in batch:
            cond, masks = self.encode_conditions_precomputed(
                dropped["spk_trunk"], dropped["spk_tmask"],
                dropped["lsn_trunk"], dropped["lsn_tmask"],
                dropped["melspec_lsn"], dropped["active_passive_lsn"],
                dropped["lsn_id"])
        else:
            cond, masks = self.encode_conditions(
                dropped["spk_ids"], dropped["spk_tmask"], dropped["lsn_ids"],
                dropped["lsn_tmask"], dropped["melspec_lsn"],
                dropped["active_passive_lsn"], dropped["lsn_id"])

        sched = self.noise_scheduler
        noise = _draw(draws, "noise", lambda k: torch.randn(
            (k * b,) + tuple(z.shape[1:]), generator=generator, device=dev),
            dev)
        timesteps = _draw(draws, "timesteps", lambda k: torch.randint(
            0, sched.num_train_timesteps, (k * b,), generator=generator,
            device=dev), dev).long()
        noisy = sched.add_noise(z, noise, timesteps)
        noise_pred, att = self.denoiser(noisy, timesteps, cond, masks)

        w = self.loss_weights
        lambda_latent = float(w.get("lambda_latent", 0.0))
        lambda_prior = float(w.get("lambda_prior", 0.0))
        lambda_ga = float(w.get("lambda_guided_attention", 0.0))
        target = noise if self.predict_epsilon else z
        np_main, np_prior, tgt_main, n_prior = noise_pred, None, target, None
        if lambda_prior != 0.0:
            if not self.predict_epsilon:
                raise ValueError("lambda_prior needs epsilon prediction (the "
                                 "reference's x-prediction path never "
                                 "chunks the target)")
            # torch.chunk: the first half takes the odd row
            h = (b + 1) // 2
            np_main, np_prior = noise_pred[:h], noise_pred[h:]
            tgt_main, n_prior = target[:h], target[h:]
        kwargs = dict(noise_pred_prior=np_prior, noise_prior=n_prior,
                      lambda_prior=lambda_prior,
                      att_mats=att if lambda_ga != 0.0 else None,
                      lambda_guided_attention=lambda_ga)
        if lambda_latent != 0.0:
            # with the prior chunk on, the latent term covers the main
            # chunk only (JAX :550-563)
            h = np_main.shape[0]
            t_main = timesteps[:h]
            pred_x0 = self.scheduler.pred_original_sample(np_main, t_main,
                                                          noisy[:h])
            weights = self.scheduler.table("betas", dev)[t_main]
            losses = diffusion_losses(np_main, tgt_main, self.predict_epsilon,
                                      pred_x0, z[:h], weights, lambda_latent,
                                      **kwargs)
        else:
            losses = diffusion_losses(np_main, tgt_main, self.predict_epsilon,
                                      **kwargs)
        return losses["total"], losses

    # ------------------------------------------------------------- sampling
    def assemble_guidance_cond(self, cond_real, masks_real, cond_unc,
                               masks_unc):
        """The seven guidance branches' conditions stacked branch-major into
        (7B, ...) rows; single uncond rows are tiled to the batch (JAX
        :570-590)."""
        def rows(real, unc, s):
            u = unc[s].expand((real[s].shape[0],) + unc[s].shape[1:])
            return torch.cat([real[s] if s in GUIDANCE_BRANCHES[g] else u
                              for g in range(NUM_BRANCHES)])

        return ({s: rows(cond_real, cond_unc, s) for s in cond_real},
                {s: rows(masks_real, masks_unc, s) for s in masks_real})

    def guidance_combine(self, noise_pred7, batch_size: int):
        """:meth:`guidance_combine_branches` of flat (7B, ...) rows."""
        return self.guidance_combine_branches(noise_pred7.reshape(
            (NUM_BRANCHES, batch_size) + noise_pred7.shape[1:]))

    def guidance_combine_branches(self, chunks):
        """uncond + gs * sum(single-modality - uncond), full-cond weight 0.
        chunks (7, B, ...)."""
        uncond = chunks[0]
        single = chunks[1:6].sum(dim=0)
        return uncond + self.guidance_scale * (single - 5.0 * uncond)

    def uses_step_kernel(self) -> bool:
        """The fused step covers guided sampling through ``Denoiser.guided``
        (its 7-branch planes; not the fused-stream layout) with epsilon
        prediction and clipping under fixed_small DDPM or eta-0 DDIM, unless
        ``TPU.PALLAS_STEP`` is false (convofusion.py:640-649)."""
        s = self.scheduler
        return (self.use_step_kernel and self.do_classifier_free_guidance
                and not self.fuse_streams
                and self.predict_epsilon and s.clip_sample
                and (s.variant == "ddpm"
                     or (s.variant == "ddim" and s.eta == 0.0)))

    def diffusion_reverse(self, cond_real, masks_real, cond_unc, masks_unc,
                          batch_size: int,
                          num_inference_steps: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          init_noise: Optional[torch.Tensor] = None,
                          step_noise: Optional[torch.Tensor] = None,
                          weg: Optional[Dict] = None,
                          weg_params: Optional[Dict] = None,
                          preseq: Optional[torch.Tensor] = None,
                          capture_attention: str = "none"):
        """The reverse process: 7-branch classifier-free guidance when
        ``guidance_scale`` > 1, else one denoiser call a step on the real
        conditions with the plain scheduler update and no step kernel (JAX
        :640-655).  ``init_noise`` (B, 16, D) and
        ``step_noise`` (n_steps, B, 16, D) replace the draws from
        ``generator`` (a test feeds JAX's own sequence; DPM-Solver++ draws
        no step noise).  ``weg`` (see :meth:`sample`) turns word-excitation
        guidance on; ``weg_params`` overrides ``cfg['weg_parameters']``.
        ``preseq`` (B, L <= 16, D): the previous window's latent tokens,
        inpainted over the first L tokens at every step.  Latents stay fp32
        whatever the compute dtype.  Returns the final latents; with
        ``capture_attention='all'``, (latents, att_seq): the full-condition
        branch's attention maps of every step, stream -> (steps, B,
        layers, Tq, Tk), kept on the device and stacked once at the end
        (JAX :614,805-856)."""
        if capture_attention not in ("none", "all"):
            raise ValueError(f"capture_attention {capture_attention!r}, not "
                             f"'none' or 'all'")
        self._check_guided()
        captured = [] if capture_attention == "all" else None
        variant = self.scheduler.variant
        if variant not in ("ddpm", "ddim", "dpmpp_2m"):
            raise NotImplementedError(
                f"scheduler variant {variant!r} is not ported")
        guided = self.do_classifier_free_guidance
        tiled = guided and self.fuse_streams
        if tiled:
            cond7, masks7 = self.assemble_guidance_cond(
                cond_real, masks_real, cond_unc, masks_unc)
        use_kernel = self.uses_step_kernel()
        is_dpmpp = variant == "dpmpp_2m"
        n_steps = num_inference_steps or self.num_inference_timesteps
        ts = self.scheduler.timesteps(n_steps)
        prev_ts = self.scheduler.prev_timesteps(n_steps)
        shape = (batch_size, self.latent_tokens, self.latent_dim)
        dev = self.device
        refine = (None if weg is None else self._weg_refiner(
            weg, n_steps, self.weg_parameters if weg_params is None
            else weg_params))

        def draw():
            if generator is None:
                raise ValueError("pass a torch.Generator, or both "
                                 "init_noise and step_noise")
            return torch.randn(shape, generator=generator, device=dev)

        latents = (draw() if init_noise is None
                   else init_noise.to(dev, torch.float32))
        latents = latents * self.scheduler.init_noise_sigma
        if preseq is not None:
            # the reference's aliasing quirk (convofusion.py:666-678): step
            # 0 re-noises the preseq with the initial noise, every later
            # step with the step-0 *noised* preseq
            preseq = preseq.to(dev, torch.float32)
            n_pre = preseq.shape[1]
            noise0 = latents[:, :n_pre]
            noise_later = self.noise_scheduler.add_noise(preseq, noise0,
                                                         int(ts[0]))
        prev_d, prev_lambda = torch.zeros_like(latents), 0.0
        is_ddpm = 1.0 if variant == "ddpm" else 0.0
        span = profiling.span
        # the guided call of every step, replayed from a CUDA graph where
        # the inputs allow (models/denoiser.GuidedGraphs); a tensor-parallel
        # placement stays eager (parallel/tp.placed_mesh's test: importing
        # that module loads torch.distributed.tensor, seconds of set-up)
        guided_call = (self.guided_graphs.bound(
            self.denoiser, self.weights_version, latents, cond_real,
            cond_unc, masks_real, masks_unc,
            placed=getattr(self, "tp_mesh", None) is not None)
            if guided and not tiled else contextlib.nullcontext())
        with span("diffusion_reverse"), guided_call as guided_denoiser:
            for i, (t, pt) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
                with span("reverse_step", i=i, t=t):
                    if preseq is not None:
                        noised = self.noise_scheduler.add_noise(
                            preseq, noise0 if i == 0 else noise_later, t)
                        latents = torch.cat([noised, latents[:, n_pre:]],
                                            dim=1)
                    if refine is not None:
                        latents = refine(latents, i, t)
                    with span("denoiser"):
                        if tiled:
                            # the fused layout: every branch's rows in one
                            # forward
                            eps, att = self.denoiser(
                                latents.repeat(NUM_BRANCHES, 1, 1), t, cond7,
                                masks7)
                            eps = self.guidance_combine(eps, batch_size)
                            att = {s: a[-batch_size:] for s, a in att.items()}
                        elif guided:
                            noise_pred7, att = guided_denoiser(latents, t)
                            if not use_kernel:
                                eps = self.guidance_combine_branches(
                                    noise_pred7)
                        else:
                            # one branch, the real conditions (JAX
                            # :654-655,837-839)
                            eps, att = self.denoiser(latents, t, cond_real,
                                                     masks_real)
                    if captured is not None:
                        # a graph's maps are rewritten by its next replay
                        captured.append({s: a.clone() for s, a in
                                         att.items()})
                    with span("step_update"):
                        if is_dpmpp:
                            latents, _, prev_d, prev_lambda = \
                                self.scheduler.dpmpp_2m_step(
                                    eps, t, pt, latents, prev_d, prev_lambda,
                                    i == 0)
                            continue
                        noise = (draw() if step_noise is None
                                 else step_noise[i].to(dev, torch.float32))
                        if use_kernel:
                            alpha_t, alpha_prev = self.scheduler.alpha_prods(
                                t, pt)
                            latents = guided_step(
                                noise_pred7, latents, noise, alpha_t,
                                alpha_prev, self.guidance_scale, is_ddpm,
                                1.0 if t > 0 else 0.0, 1.0)
                        else:
                            latents, _ = self.scheduler.step(
                                eps, t, pt, latents, noise=noise)
        if captured is None:
            return latents
        return latents, {s: torch.stack([a[s] for a in captured])
                         for s in captured[0]}

    def _check_guided(self) -> None:
        """Guided sampling with the trans_enc denoiser raises before any
        work: it has no guided path (JAX fails on the missing decoder)."""
        if self.do_classifier_free_guidance and not self.fuse_streams and \
                self.denoiser.arch == "trans_enc":
            raise ValueError(
                "guided sampling (guidance_scale > 1) needs the trans_dec "
                "denoiser; model.denoiser.params.arch='trans_enc' samples "
                "unguided only (model.guidance_scale=1.0)")

    def _weg_refiner(self, weg: Dict, n_steps: int, wp: Dict):
        """refine(latents, i, t) for reverse step i: one loss + gradient
        pass decides the refinement and, when it does not trigger, feeds
        the single gradient step (convofusion_tpu/models/convofusion.py:
        766-798).  The host reads the loss only at steps with a threshold
        and in each refinement iteration; the single step's ``loss > 0``
        choice stays on the device."""
        sched = weg_lib.weg_schedule(wp, n_steps)
        counts = self.weg_counts

        def text_only_att(lat, t):
            counts.text_only_passes += 1
            _, att = self.denoiser.text_only(lat, t, weg["cond_text"],
                                             weg["masks_text"])
            return att["tlsn"]

        loss_grad = weg_lib.value_and_grad(weg_lib.make_weg_loss(
            text_only_att, weg["focus_idx"], weg["focus_valid"],
            weg["eot_idx"]))

        def refine(lat, i, t):
            thr, step_size = sched.thresholds[i], sched.step_sizes[i]
            loss, grad = loss_grad(lat, t)
            # need = (thr > 0) & (loss0 > 1 - thr), 1 - thr in fp32
            if thr > 0 and float(loss) > float(np.float32(1.0)
                                               - np.float32(thr)):
                lat, _, n = weg_lib.iterative_refinement(
                    loss_grad, lat, t, thr, step_size,
                    sched.max_refinement_steps)
                counts.refinement_iterations += n
                counts.refined_steps += 1
                # the refined latents changed: a fresh pass
                loss, grad = loss_grad(lat, t)
            if i < sched.max_iter_to_alter:
                lat = torch.where(loss > 0, lat - step_size * grad, lat)
            return lat

        return refine

    def weg_inputs(self, focus: Dict, cond_real, masks_real, cond_unc,
                   masks_unc) -> Dict:
        """The ``weg`` dict of :meth:`diffusion_reverse` from ``focus``
        (focus_idx (B, K) int, focus_valid (B, K) bool): the text-only
        condition is guidance branch 1, tlsn real and every other stream
        uncond (reference convofusion.py:449-450); the eot index is the
        first pad position minus 1 (convofusion.py:461)."""
        dev = self.device
        pad = masks_real["tlsn"]
        first_pad = pad.int().argmax(dim=1)
        eot = torch.where(pad.any(dim=1), first_pad - 1, pad.shape[1] - 1)
        return {
            "cond_text": {s: (cond_real[s] if s == "tlsn" else cond_unc[s])
                          for s in cond_real},
            "masks_text": {s: (masks_real[s] if s == "tlsn"
                               else masks_unc[s]) for s in masks_real},
            "focus_idx": torch.as_tensor(np.asarray(focus["focus_idx"]),
                                         device=dev).long(),
            "focus_valid": torch.as_tensor(
                np.asarray(focus["focus_valid"]), device=dev).float(),
            "eot_idx": eot,
        }

    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               num_inference_steps: Optional[int] = None,
               init_noise: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None,
               uncond_cache=None, focus: Optional[Dict] = None,
               weg_params: Optional[Dict] = None,
               preseq: Optional[torch.Tensor] = None,
               capture_attention: str = "none"):
        """End-to-end generation for a ``prepare_arrays`` batch.
        ``uncond_cache``: optional (cond_unc, masks_unc) from
        :meth:`encode_uncond`.  ``focus``: optional dict(focus_idx,
        focus_valid) (numpy, from ``tokenizer.focus_word_indices``) turns
        WEG on; ``weg_params`` overrides ``cfg['weg_parameters']``.
        ``preseq``: the previous window's latent tokens to inpaint (see
        :meth:`diffusion_reverse`).  Runs
        under ``no_grad``, not ``inference_mode``: WEG builds a graph
        through the latents from conditions encoded here.  Returns (motion
        (B, 128, nfeats), latents (B, 16, D); without a VAE the motion is
        the latents); with
        ``capture_attention='all'`` (motion, latents, att_seq), att_seq the
        full-condition attention maps of every step (see
        :meth:`diffusion_reverse`)."""
        b = batch["lsn_ids"].shape[0]
        self._check_guided()
        with profiling.span("sample", rows=b):
            cond_real, masks_real = self.encode_conditions(
                batch["spk_ids"], batch["spk_tmask"], batch["lsn_ids"],
                batch["lsn_tmask"], batch["melspec_lsn"],
                batch["active_passive_lsn"], batch["lsn_id"])
            cond_unc, masks_unc = (uncond_cache if uncond_cache is not None
                                   else self.encode_uncond(batch))
            weg = (None if focus is None else self.weg_inputs(
                focus, cond_real, masks_real, cond_unc, masks_unc))
            out = self.diffusion_reverse(
                cond_real, masks_real, cond_unc, masks_unc, b,
                num_inference_steps, generator, init_noise, step_noise, weg,
                weg_params, preseq, capture_attention)
            latents = out if capture_attention == "none" else out[0]
            if self.vae is None:
                motion = latents        # the identity decode (JAX :928-931)
            else:
                # (B, 16, D) -> (2, B, 8, D): tokens alternate body, hands
                # per chunk
                z = latents.reshape(b, self.n_chunks, 2, self.latent_dim)
                z = torch.stack([z[:, :, 0], z[:, :, 1]], dim=0)
                with profiling.span("vae.decode"):
                    motion = self.vae.decode(z, self.max_len)
        if capture_attention == "none":
            return motion, latents
        return motion, latents, out[1]

    def cached_sampler(self, num_inference_steps: Optional[int] = None,
                       weg_params: Optional[Dict] = None,
                       capture_attention: str = "none"
                       ) -> "CachedSampler":
        """The model's :class:`CachedSampler` for these settings, shared by
        every caller with the same step count, WEG parameters and capture
        (the rollout's windows and calls, the service, the test CLI)."""
        caches = self.__dict__.setdefault("_sampler_caches", {})
        key = (num_inference_steps, repr(weg_params), capture_attention)
        if key not in caches:
            caches[key] = CachedSampler(self, num_inference_steps,
                                        weg_params, capture_attention)
        return caches[key]


class CachedSampler:
    """:meth:`Convofusion.sample` with the uncond conditions cached.

    The uncond branch depends on the weights and the batch geometry only
    (:meth:`Convofusion.encode_uncond`), so it is encoded once per
    geometry at batch 1.  The cache is keyed on the model's
    ``weights_version``, which ``load_state_dict`` bumps.  ``weg_params``
    overrides the model's WEG parameters in every call (the rollout's
    constants); ``capture_attention`` is passed to every ``sample``.  The sampler holds its model by a weak reference: the
    model keeps its samplers, and a strong reference back would be a cycle
    that keeps a dropped model's weights on the card until the garbage
    collector runs.  (The JAX ``CachedSampler`` also caches compiled
    executables; eager PyTorch has none.)"""

    def __init__(self, model: Convofusion,
                 num_inference_steps: Optional[int] = None,
                 weg_params: Optional[Dict] = None,
                 capture_attention: str = "none"):
        self._model = weakref.ref(model)
        self.num_inference_steps = num_inference_steps
        self.weg_params = weg_params
        self.capture_attention = capture_attention
        self._uncond = {}
        self._version = None

    @property
    def model(self) -> Convofusion:
        model = self._model()
        if model is None:
            raise RuntimeError("the CachedSampler's model was deleted: get "
                               "a sampler from a live model's "
                               "cached_sampler()")
        return model

    def uncond_for(self, arrays):
        if self._version != self.model.weights_version:
            self._uncond.clear()
            self._version = self.model.weights_version
        geom = tuple(tuple(arrays[k].shape[1:]) for k in (
            "uncond_ids", "melspec_lsn", "active_passive_lsn"))
        if geom not in self._uncond:
            slim = {k: arrays[k][:1] for k in (
                "uncond_ids", "uncond_tmask", "melspec_lsn",
                "active_passive_lsn", "lsn_id")}
            with torch.no_grad():
                self._uncond[geom] = self.model.encode_uncond(slim)
        return self._uncond[geom]

    def __call__(self, arrays, generator: Optional[torch.Generator] = None,
                 focus: Optional[Dict] = None,
                 init_noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[torch.Tensor] = None,
                 preseq: Optional[torch.Tensor] = None):
        """What :meth:`Convofusion.sample` returns: (motion, latents), and
        att_seq with ``capture_attention='all'``."""
        return self.model.sample(
            arrays, generator, self.num_inference_steps, init_noise,
            step_noise, uncond_cache=self.uncond_for(arrays), focus=focus,
            weg_params=self.weg_params, preseq=preseq,
            capture_attention=self.capture_attention)


def gen_from_latent(model: Convofusion, latent: torch.Tensor,
                    nframes: Optional[int] = None) -> torch.Tensor:
    """Decode motion straight from a (2, B, n_chunks, D) latent
    (convofusion_tpu/models/convofusion.py:1035-1038)."""
    model._require_vae("gen_from_latent")
    return model.vae.decode(latent, nframes or model.max_len)
