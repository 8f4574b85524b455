"""Convofusion generation: encode conditions, guided reverse diffusion,
VAE decode.

Port of ``convofusion_tpu/models/convofusion.py``: ``encode_text``,
``encode_conditions``, ``encode_uncond``, ``diffusion_reverse`` and
``sample`` (:330-383,604-943), guided path only (no WEG, no ``preseq``).
Weights live in the modules; ``compat/from_jax.state_dict_from_jax``
carries a JAX parameter tree across.

Per ``sample()``: the conditions are encoded once (T5 x2, the mel MLP and
the fuser; the uncond branch at batch 1), then each of the N reverse steps
is one 7-branch ``Denoiser.guided`` call followed by one launch of the
fused guidance + scheduler step kernel (``ops/guided_step.py``), then the
VAE decodes (B, 16, D) latents to (B, 128, 189) motion.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from convofusion_tpu_torch import resolve_device, resolve_dtype
from convofusion_tpu_torch.diffusion.schedulers import scheduler_from_config
from convofusion_tpu_torch.models.audioenc import AudioConvEncoder
from convofusion_tpu_torch.models.condfuser import TextAudioMotionFuser
from convofusion_tpu_torch.models.denoiser import Denoiser
from convofusion_tpu_torch.models.t5 import T5TextEncoder
from convofusion_tpu_torch.models.tokenizer import (
    UNCOND_TEXT,
    WordHashTokenizer,
)
from convofusion_tpu_torch.models.vae import (
    BODY_NFEATS,
    HANDS_NFEATS,
    ConvoFusionVae,
)
from convofusion_tpu_torch.ops.guided_step import guided_step
from convofusion_tpu_torch.ops.layers import init_weights


def uncond_melspec(shape, dtype=torch.float32, device=None):
    """-90 dB everywhere except mel bins 40:45 (reference
    convofusion.py:214-216)."""
    mel = torch.full(shape, -90.0, dtype=dtype, device=device)
    mel[..., 40:45] = 0.0
    return mel


class Convofusion(nn.Module):
    """The stage-2 model for generation.

    ``cfg`` is a dict shaped like ``config.PRODUCTION``; ``dtype`` the
    compute dtype of every module ('float32' or 'bfloat16'); ``device``
    None means the card (raises without one); ``seed`` seeds the weight
    init (None keeps PyTorch's default init, for weights loaded after)."""

    def __init__(self, cfg: Dict, dtype="float32", device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        dtype = resolve_dtype(dtype)
        device = resolve_device(device)
        self.latent_size, self.latent_dim = (int(v) for v in cfg["latent_dim"])
        self.max_len = int(cfg["max_len"])
        self.n_chunks = self.max_len // 16
        self.latent_tokens = 2 * self.n_chunks
        self.text_pad_len = int(cfg["text_pad_len"])
        self.guidance_scale = float(cfg["guidance_scale"])
        self.do_classifier_free_guidance = self.guidance_scale > 1.0
        self.predict_epsilon = bool(cfg["predict_epsilon"])
        if int(cfg["nfeats"]) != BODY_NFEATS + HANDS_NFEATS:
            raise ValueError(f"nfeats {cfg['nfeats']}: the VAE decodes "
                             f"{BODY_NFEATS} + {HANDS_NFEATS} features")
        te = cfg["text_encoder"]
        self.tokenizer = WordHashTokenizer(vocab_size=int(te["vocab_size"]),
                                           max_length=self.text_pad_len)
        d = int(cfg["denoiser"]["text_encoded_dim"])

        self.vae = ConvoFusionVae(latent_dim=self.latent_dim,
                                  **cfg["motion_vae"], dtype=dtype)
        self.text_encoder = T5TextEncoder(**te, dtype=dtype)
        self.audio_encoder = AudioConvEncoder(**cfg["audio_encoder"],
                                              dtype=dtype)
        # the JAX model builds its fuser without a compute dtype
        # (convofusion_tpu/models/convofusion.py:146-147): its embedding
        # rows stay fp32 in a bf16 model
        self.condition_fuser = TextAudioMotionFuser(out_dim=d)
        self.denoiser = Denoiser(latent_dim=self.latent_dim,
                                 **cfg["denoiser"], dtype=dtype)
        self.scheduler = scheduler_from_config(cfg["scheduler"],
                                               self.predict_epsilon)
        self.num_inference_timesteps = int(
            cfg["scheduler"]["num_inference_timesteps"])
        if seed is not None:
            init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.denoiser.latent_embd.weight.device

    # ------------------------------------------------------- host-side text
    def tokenize(self, texts):
        return self.tokenizer(list(texts), pad_to=self.text_pad_len)

    def prepare_text_batch(self, texts_spk, texts_lsn):
        """Strings -> static-shape id (int64) / mask (bool) tensors on the
        model's device, incl. the uncond rows."""
        device = self.device
        tb_spk = self.tokenize(texts_spk)
        tb_lsn = self.tokenize(texts_lsn)
        tb_unc = self.tokenize([UNCOND_TEXT] * len(texts_lsn))

        def ids(tb):
            return torch.from_numpy(tb.input_ids).long().to(device)

        def mask(tb):
            return torch.from_numpy(tb.attention_mask).to(device)

        return {
            "spk_ids": ids(tb_spk), "spk_tmask": mask(tb_spk),
            "lsn_ids": ids(tb_lsn), "lsn_tmask": mask(tb_lsn),
            "uncond_ids": ids(tb_unc), "uncond_tmask": mask(tb_unc),
        }, tb_spk, tb_lsn

    # ------------------------------------------------------ condition encoding
    def encode_text(self, ids, tmask):
        emb, _ = self.text_encoder(ids, tmask)
        return emb

    def encode_conditions(self, spk_ids, spk_tmask, lsn_ids, lsn_tmask,
                          melspec_lsn, apb, lsn_id):
        """Returns (cond dict, mask dict); masks are pad masks (True =
        pad) for the two text streams."""
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

    # ------------------------------------------------------------- sampling
    def guidance_combine_branches(self, chunks):
        """uncond + gs * sum(single-modality - uncond), full-cond weight 0.
        chunks (7, B, ...)."""
        uncond = chunks[0]
        single = chunks[1:6].sum(dim=0)
        return uncond + self.guidance_scale * (single - 5.0 * uncond)

    def uses_step_kernel(self) -> bool:
        """The fused step covers epsilon prediction with clipping under
        fixed_small DDPM or eta-0 DDIM (convofusion.py:640-649)."""
        s = self.scheduler
        return (self.do_classifier_free_guidance and self.predict_epsilon
                and s.clip_sample
                and (s.variant == "ddpm"
                     or (s.variant == "ddim" and s.eta == 0.0)))

    def diffusion_reverse(self, cond_real, masks_real, cond_unc, masks_unc,
                          batch_size: int,
                          num_inference_steps: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          init_noise: Optional[torch.Tensor] = None,
                          step_noise: Optional[torch.Tensor] = None):
        """Guided reverse process.  ``init_noise`` (B, 16, D) and
        ``step_noise`` (n_steps, B, 16, D) replace the draws from
        ``generator`` (a test feeds JAX's own sequence).  Latents stay fp32
        whatever the compute dtype.  Returns the final latents."""
        if not self.do_classifier_free_guidance:
            raise NotImplementedError(
                "only guided sampling (guidance_scale > 1) is ported")
        if self.scheduler.variant not in ("ddpm", "ddim"):
            raise NotImplementedError(
                f"scheduler variant {self.scheduler.variant!r} is not ported")
        use_kernel = self.uses_step_kernel()
        n_steps = num_inference_steps or self.num_inference_timesteps
        ts = self.scheduler.timesteps(n_steps)
        prev_ts = self.scheduler.prev_timesteps(n_steps)
        shape = (batch_size, self.latent_tokens, self.latent_dim)
        dev = self.device

        def draw():
            if generator is None:
                raise ValueError("pass a torch.Generator, or both "
                                 "init_noise and step_noise")
            return torch.randn(shape, generator=generator, device=dev)

        latents = (draw() if init_noise is None
                   else init_noise.to(dev, torch.float32))
        latents = latents * self.scheduler.init_noise_sigma
        is_ddpm = 1.0 if self.scheduler.variant == "ddpm" else 0.0
        for i, (t, pt) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
            noise_pred7, _ = self.denoiser.guided(
                latents, t, cond_real, cond_unc, masks_real, masks_unc)
            noise = (draw() if step_noise is None
                     else step_noise[i].to(dev, torch.float32))
            if use_kernel:
                alpha_t, alpha_prev = self.scheduler.alpha_prods(t, pt)
                latents = guided_step(
                    noise_pred7, latents, noise, alpha_t, alpha_prev,
                    self.guidance_scale, is_ddpm, 1.0 if t > 0 else 0.0, 1.0)
            else:
                eps = self.guidance_combine_branches(noise_pred7)
                latents, _ = self.scheduler.step(eps, t, pt, latents,
                                                 noise=noise)
        return latents

    @torch.inference_mode()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               num_inference_steps: Optional[int] = None,
               init_noise: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None,
               uncond_cache=None):
        """End-to-end generation for a ``prepare_arrays`` batch.
        ``uncond_cache``: optional (cond_unc, masks_unc) from
        :meth:`encode_uncond`.  Returns (motion (B, 128, nfeats), latents
        (B, 16, D))."""
        b = batch["lsn_ids"].shape[0]
        cond_real, masks_real = self.encode_conditions(
            batch["spk_ids"], batch["spk_tmask"], batch["lsn_ids"],
            batch["lsn_tmask"], batch["melspec_lsn"],
            batch["active_passive_lsn"], batch["lsn_id"])
        cond_unc, masks_unc = (uncond_cache if uncond_cache is not None
                               else self.encode_uncond(batch))
        latents = self.diffusion_reverse(
            cond_real, masks_real, cond_unc, masks_unc, b,
            num_inference_steps, generator, init_noise, step_noise)
        # (B, 16, D) -> (2, B, 8, D): tokens alternate body, hands per chunk
        z = latents.reshape(b, self.n_chunks, 2, self.latent_dim)
        z = torch.stack([z[:, :, 0], z[:, :, 1]], dim=0)
        return self.vae.decode(z, self.max_len), latents
