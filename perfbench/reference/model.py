"""Plain fp32 PyTorch reference of ConvoFusion, written from the published
model description and independent of the program under test.

Every function reads the weights from ``P``, a dict that maps the
parameter names of the model's state dict to fp32 tensors, and the sizes
from a configuration dict (``perfbench/configs/*.json``'s ``model``).  It
holds no module objects, no kernels, no caches and no batching tricks:
each guidance branch is its own denoiser pass, each attention is a plain
softmax.

``Ref(P, cfg, lowp=..., masks=...)`` selects the matrix-product precision
and, for a training step, the generator its dropout masks come from.
``lowp=None`` is the reference: float32 with TF32 off.  ``lowp='fp8'`` is
the control of the cells whose configuration states bfloat16: every
matrix product's two operands are rounded to float8 e4m3 with a
per-tensor scale (the forward value; the gradient passes straight
through), as an fp8 GEMM would compute them.

Dropout is the model's own, at the published rates: with ``masks`` (a
``torch.Generator``) each site draws a Bernoulli(1 - rate) mask of its
tensor's shape from it, one site after another in the order the layer
equations reach them (attention weights after the softmax, the residual
branch of each sublayer, the FFN's hidden layer, the TimeBlock's hidden
layer, the audio MLP's two hidden layers), and scales the kept values by
1 / (1 - rate); a step that draws from a generator seeded alike draws the
same masks.  Without ``masks`` (sampling, a frozen encoder) there is none.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

COND_STREAMS = ("spkemb", "alsn", "tlsn", "apb", "lsnemb")
# guidance branch -> the streams that keep their real value:
# [all dropped, text, audio, speaker, active/passive, listener id, full]
GUIDANCE_BRANCHES = ((), ("tlsn",), ("alsn",), ("spkemb",), ("apb",),
                     ("lsnemb",), COND_STREAMS)
BODY_NFEATS, HANDS_NFEATS = 23 * 3, 40 * 3
CHUNK = 16
NUM_APB, NUM_LSN_IDS = 3, 36
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0


# ------------------------------------------------------------ parameters
def _attn_specs(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.in_proj_weight", (3 * d, d)),
            (f"{prefix}.in_proj_bias", (3 * d,)),
            (f"{prefix}.out_proj.weight", (d, d)),
            (f"{prefix}.out_proj.bias", (d,))]


def _lin(prefix: str, n_out: int, n_in: int, bias: bool = True):
    out = [(f"{prefix}.weight", (n_out, n_in))]
    return out + ([(f"{prefix}.bias", (n_out,))] if bias else [])


def _norm(prefix: str, d: int):
    return [(f"{prefix}.weight", (d,)), (f"{prefix}.bias", (d,))]


def _skip_stack_specs(prefix: str, d: int, ff: int, layers: int,
                      decoder: bool):
    def layer(p):
        out = _attn_specs(f"{p}.self_attn", d)
        if decoder:
            out += _attn_specs(f"{p}.multihead_attn", d)
        out += _lin(f"{p}.linear1", ff, d) + _lin(f"{p}.linear2", d, ff)
        for i in range(1, 4 if decoder else 3):
            out += _norm(f"{p}.norm{i}", d)
        return out

    n = (layers - 1) // 2
    out = []
    for j in range(n):
        out += layer(f"{prefix}.input_blocks.{j}")
        out += layer(f"{prefix}.output_blocks.{j}")
        out += _lin(f"{prefix}.linear_blocks.{j}", d, 2 * d)
    return out + layer(f"{prefix}.middle_block") + _norm(f"{prefix}.norm", d)


def vae_specs(cfg: Dict) -> List[Tuple[str, tuple]]:
    d = int(cfg["latent_dim"][1])
    mv = cfg["motion_vae"]
    ff, nl = int(mv["ff_size"]), int(mv["num_layers"])
    ntok = 2 * int(cfg["latent_dim"][0])
    out = []
    for part, nf in (("body", BODY_NFEATS), ("hands", HANDS_NFEATS)):
        out.append((f"vae.{part}_global_motion_token", (ntok, d)))
        out += _skip_stack_specs(f"vae.{part}_encoder", d, ff, nl, False)
        out += _skip_stack_specs(f"vae.{part}_decoder", d, ff, nl, True)
        out += _lin(f"vae.{part}_skel_embedding", d, nf)
        out += _lin(f"vae.{part}_final_layer", nf, d)
    return out


def param_specs(cfg: Dict, stage: str) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of the model of ``stage`` ('vae'
    or 'diffusion'), in the state dict's names."""
    out = vae_specs(cfg)
    if stage == "vae":
        return out
    te = cfg["text_encoder"]
    dm, dff, nh, dkv = (int(te[k]) for k in ("d_model", "d_ff", "num_heads",
                                              "d_kv"))
    inner = nh * dkv
    t5 = "text_encoder.text_model.encoder"
    out.append((f"{t5}.embed_tokens.weight", (int(te["vocab_size"]), dm)))
    for i in range(int(te["num_layers"])):
        b = f"{t5}.block.{i}.layer"
        for w in "qkv":
            out.append((f"{b}.0.SelfAttention.{w}.weight", (inner, dm)))
        out.append((f"{b}.0.SelfAttention.o.weight", (dm, inner)))
        if i == 0:
            out.append((f"{b}.0.SelfAttention.relative_attention_bias."
                        f"weight", (32, nh)))
        out.append((f"{b}.0.layer_norm.weight", (dm,)))
        out += _lin(f"{b}.1.DenseReluDense.wi", dff, dm, bias=False)
        out += _lin(f"{b}.1.DenseReluDense.wo", dm, dff, bias=False)
        out.append((f"{b}.1.layer_norm.weight", (dm,)))
    out.append((f"{t5}.final_layer_norm.weight", (dm,)))
    d = int(cfg["denoiser"]["text_encoded_dim"])
    out += _lin("text_encoder.projection.1", int(te["latent_dim"]), dm)
    ae = cfg["audio_encoder"]
    hid, lat = int(ae["hidden_size"]), int(ae["latent_dim"])
    out += (_lin("audio_encoder.main.0", hid, int(ae["input_size"]))
            + _lin("audio_encoder.main.3", lat, hid)
            + _lin("audio_encoder.out_net", lat, lat))
    out += [("condition_fuser.active_passive_emb.weight", (NUM_APB, d)),
            ("condition_fuser.lsn_id_emb.weight", (NUM_LSN_IDS, d))]
    den = cfg["denoiser"]
    ld, ff = int(cfg["latent_dim"][1]), int(den["ff_size"])
    out += (_lin("denoiser.latent_embd", d, ld)
            + _lin("denoiser.latent_proj", ld, d)
            + _lin("denoiser.time_embedding.linear_1", d, d)
            + _lin("denoiser.time_embedding.linear_2", d, d)
            + [("denoiser.bh_embedding.weight", (2, d)),
               ("denoiser.condition_embedding.weight",
                (len(COND_STREAMS), d))])
    for i in range(int(den["num_layers"])):
        p = f"denoiser.decoder.layers.{i}"
        out += _attn_specs(f"{p}.self_attn", d)
        for tb in ("time_block1", "time_block2"):
            out += (_lin(f"{p}.{tb}.emb_layers.1", 2 * d, d)
                    + _norm(f"{p}.{tb}.norm", d)
                    + _lin(f"{p}.{tb}.out_layers.2", d, d))
        for n in range(1, 4):
            out += _norm(f"{p}.norm{n}", d)
        for s in COND_STREAMS:
            out += _attn_specs(f"{p}.multihead_attn_{s}", d)
            out += _norm(f"{p}.{s}_norm", d)
        out += (_lin(f"{p}.att_fuser", d, len(COND_STREAMS) * d)
                + _lin(f"{p}.linear1", ff, d) + _lin(f"{p}.linear2", d, ff))
    return out + _norm("denoiser.decoder.norm", d)


def trainable(name: str, stage: str) -> bool:
    """The T5 trunk never trains; stage 2 freezes the whole VAE."""
    if name.startswith("text_encoder.text_model."):
        return False
    return not (stage == "diffusion" and name.startswith("vae."))


# ------------------------------------------------------------ fixed tables
def sine_table(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float().to(device)


def alphas_cumprod(sch: Dict) -> np.ndarray:
    """float64 cumulative products of 1 - beta (scaled_linear betas)."""
    if sch["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta schedule {sch['beta_schedule']!r}")
    betas = np.linspace(float(sch["beta_start"]) ** 0.5,
                        float(sch["beta_end"]) ** 0.5,
                        int(sch["num_train_timesteps"])) ** 2
    # the configuration's tables are held in float32
    return np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)


def t5_buckets(t: int, num_buckets: int = 32, max_distance: int = 128):
    """Bidirectional T5 relative-position buckets of (j - i), (t, t)."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    half = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * half
    n = np.abs(rel)
    exact = half // 2
    large = exact + (np.log(np.maximum(n, 1) / exact)
                     / np.log(max_distance / exact)
                     * (half - exact)).astype(np.int32)
    large = np.minimum(large, half - 1)
    return torch.from_numpy(ret + np.where(n < exact, n, large))


def channel_weights(nfeats: int, device) -> torch.Tensor:
    """Recon weights (root x10, hands and arms x5) and Laplace weights."""
    w = torch.ones(2, nfeats)
    w[0, :3] = 10.0
    arms = list(range(15, 39)) + list(range(69, nfeats))
    w[:, arms] = 5.0
    return w.to(device)


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    xd = x.detach()
    scale = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - xd)


class Ref:
    """The model's forward passes over the weights ``P``."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: Dict,
                 lowp: str | None = None,
                 masks: torch.Generator | None = None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"lowp {lowp!r}")
        self.P, self.cfg, self.lowp, self.masks = P, cfg, lowp, masks
        self.dev = next(iter(P.values())).device

    def rate(self, group: str) -> float:
        """The dropout rate of a configuration group, 0 outside training."""
        if self.masks is None:
            return 0.0
        return float(self.cfg[group].get("dropout", 0.0))

    def drop(self, x, rate: float):
        if not rate:
            return x
        keep = 1.0 - rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.masks)
        return x * mask * (1.0 / keep)

    # -- primitives
    def mm(self, a, b):
        if self.lowp == "fp8":
            a, b = _fake_fp8(a), _fake_fp8(b)
        return a @ b

    def linear(self, x, name, bias=True):
        y = self.mm(x, self.P[f"{name}.weight"].t())
        return y + self.P[f"{name}.bias"] if bias else y

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], 1e-5)

    def rms_norm(self, x, name):
        var = x.square().mean(dim=-1, keepdim=True)
        return self.P[f"{name}.weight"] * x * torch.rsqrt(var + 1e-6)

    def attend(self, q, k, v, heads, pad=None, scale=True, rate=0.0):
        """q (B, Tq, D), k/v (B, Tk, D); pad (B, Tk) True = padding;
        ``rate`` the attention weights' dropout."""
        b, tq, d = q.shape
        tk, hd = k.shape[1], d // heads
        q = q.reshape(b, tq, heads, hd).transpose(1, 2)
        k = k.reshape(k.shape[0], tk, heads, hd).transpose(1, 2)
        v = v.reshape(v.shape[0], tk, heads, hd).transpose(1, 2)
        logits = self.mm(q, k.transpose(-1, -2))
        if scale:
            logits = logits / math.sqrt(hd)
        if pad is not None:
            logits = logits.masked_fill(pad[:, None, None, :], -1e9)
        w = self.drop(torch.softmax(logits, dim=-1), rate)
        return self.mm(w, v).transpose(1, 2).reshape(b, tq, d)

    def mha(self, name, q_in, kv_in, heads, pad=None, rate=0.0):
        W, bias = self.P[f"{name}.in_proj_weight"], self.P[f"{name}.in_proj_bias"]
        d = W.shape[1]
        q = self.mm(q_in, W[:d].t()) + bias[:d]
        k = self.mm(kv_in, W[d:2 * d].t()) + bias[d:2 * d]
        v = self.mm(kv_in, W[2 * d:].t()) + bias[2 * d:]
        return self.linear(self.attend(q, k, v, heads, pad, rate=rate),
                           f"{name}.out_proj")

    def ffn(self, x, p, rate=0.0):
        return self.linear(self.drop(F.gelu(self.linear(x, f"{p}.linear1")),
                                     rate), f"{p}.linear2")

    # -- text encoder: the T5 trunk, then ReLU + Linear
    def t5(self, ids, valid):
        te = self.cfg["text_encoder"]
        nh = int(te["num_heads"])
        pre = "text_encoder.text_model.encoder"
        x = self.P[f"{pre}.embed_tokens.weight"][ids]
        t = ids.shape[1]
        table = self.P[f"{pre}.block.0.layer.0.SelfAttention."
                       f"relative_attention_bias.weight"]
        bias = table[t5_buckets(t).to(self.dev)].permute(2, 0, 1)[None]
        b = x.shape[0]
        for i in range(int(te["num_layers"])):
            blk = f"{pre}.block.{i}.layer"
            h = self.rms_norm(x, f"{blk}.0.layer_norm")
            sa = f"{blk}.0.SelfAttention"
            q, k, v = (self.linear(h, f"{sa}.{w}", bias=False).reshape(
                b, t, nh, -1).transpose(1, 2) for w in "qkv")
            s = self.mm(q, k.transpose(-1, -2)) + bias
            s = s.masked_fill(~valid[:, None, None, :], -1e9)
            o = self.mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(
                b, t, -1)
            x = x + self.linear(o, f"{sa}.o", bias=False)
            h = self.rms_norm(x, f"{blk}.1.layer_norm")
            ff = f"{blk}.1.DenseReluDense"
            x = x + self.linear(F.relu(self.linear(h, f"{ff}.wi", False)),
                                f"{ff}.wo", False)
        return self.rms_norm(x, f"{pre}.final_layer_norm")

    def text(self, ids, valid):
        return self.linear(F.relu(self.t5(ids, valid)),
                           "text_encoder.projection.1")

    def audio(self, mel):
        r = self.rate("audio_encoder")
        h = F.leaky_relu(self.drop(self.linear(mel, "audio_encoder.main.0"),
                                   r), 0.1)
        h = F.leaky_relu(self.drop(self.linear(h, "audio_encoder.main.3"),
                                   r), 0.1)
        return self.linear(h, "audio_encoder.out_net")

    def conditions(self, spk_ids, spk_valid, lsn_ids, lsn_valid, mel, apb,
                   lsn_id):
        """The five condition streams and their padding masks."""
        cond = {
            "spkemb": self.text(spk_ids, spk_valid),
            "alsn": self.audio(mel),
            "tlsn": self.text(lsn_ids, lsn_valid),
            "apb": self.P["condition_fuser.active_passive_emb.weight"][apb],
            "lsnemb": self.P["condition_fuser.lsn_id_emb.weight"][
                lsn_id][:, None],
        }
        return cond, {"spkemb": ~spk_valid, "tlsn": ~lsn_valid}

    # -- denoiser
    def time_embedding(self, t, b):
        d = int(self.cfg["denoiser"]["text_encoded_dim"])
        half = d // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float64) / half).float().to(self.dev)
        ts = torch.as_tensor(t, device=self.dev).float().reshape(-1)
        ts = ts.expand(b) if ts.numel() == 1 else ts
        arg = ts[:, None] * freqs[None]
        emb = torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)
        h = F.silu(self.linear(emb, "denoiser.time_embedding.linear_1"))
        return self.linear(h, "denoiser.time_embedding.linear_2")[:, None]

    def time_block(self, x, temb, p, rate=0.0):
        h = self.linear(F.silu(temb), f"{p}.emb_layers.1")
        scale, shift = h.chunk(2, dim=-1)
        h = self.layer_norm(x, f"{p}.norm") * (1 + scale) + shift
        return self.linear(self.drop(F.silu(h), rate), f"{p}.out_layers.2")

    def denoise(self, latents, t, cond, pads):
        """One denoiser pass: latents (B, 16, D_lat), t a number or (B,),
        cond[stream] (B, Tk, d), pads[stream] (B, Tk) or absent."""
        den = self.cfg["denoiser"]
        nh, r = int(den["num_heads"]), self.rate("denoiser")
        b, n, _ = latents.shape
        x = self.linear(latents, "denoiser.latent_embd")
        d = x.shape[-1]
        temb = self.time_embedding(t, b)
        bh = self.P["denoiser.bh_embedding.weight"][torch.arange(n) % 2]
        pe = sine_table(1024, d, self.dev)
        x = x + bh[None] + pe[torch.arange(n) // 2][None]
        cemb = self.P["denoiser.condition_embedding.weight"]
        mem = {s: cond[s] + temb + cemb[i] + pe[:cond[s].shape[1]]
               for i, s in enumerate(COND_STREAMS)}
        for i in range(int(den["num_layers"])):
            p = f"denoiser.decoder.layers.{i}"
            h = self.layer_norm(x, f"{p}.norm1")
            x = x + self.drop(self.mha(f"{p}.self_attn", h, h, nh, rate=r),
                              r)
            x = x + self.time_block(x, temb, f"{p}.time_block1", r)
            q = self.layer_norm(x, f"{p}.norm2")
            outs = [self.mha(f"{p}.multihead_attn_{s}", q,
                             self.layer_norm(mem[s], f"{p}.{s}_norm"), 1,
                             pads.get(s), rate=r)
                    for s in COND_STREAMS]
            x = x + self.drop(self.linear(torch.cat(outs, -1),
                                          f"{p}.att_fuser"), r)
            x = x + self.time_block(x, temb, f"{p}.time_block2", r)
            x = x + self.drop(self.ffn(self.layer_norm(x, f"{p}.norm3"), p,
                                       r), r)
        x = self.layer_norm(x, "denoiser.decoder.norm")
        return self.linear(x, "denoiser.latent_proj")

    def branch(self, g, cond, pads, cond_u, pads_u):
        """Guidance branch ``g``'s conditions: real streams of the branch,
        the uncond rows (batch 1, broadcast) for the others."""
        b = cond["tlsn"].shape[0]
        c, m = {}, {}
        for s in COND_STREAMS:
            real = s in GUIDANCE_BRANCHES[g]
            c[s] = cond[s] if real else cond_u[s].expand(
                (b,) + cond_u[s].shape[1:])
            src = pads if real else pads_u
            if s in src:
                m[s] = src[s].expand(b, -1) if not real else src[s]
        return c, m

    def guided_eps(self, latents, t, cond, pads, cond_u, pads_u):
        """uncond + gs * (sum of the five single-stream branches - 5
        uncond); the full-condition branch has weight 0 and is skipped."""
        gs = float(self.cfg["guidance_scale"])
        eps = [self.denoise(latents, t, *self.branch(g, cond, pads, cond_u,
                                                      pads_u))
               for g in range(6)]
        uncond = eps[0]
        single = eps[1] + eps[2] + eps[3] + eps[4] + eps[5]
        return uncond + gs * (single - 5.0 * uncond)

    # -- VAE
    def skip_stack(self, x, prefix, memory=None):
        mv = self.cfg["motion_vae"]
        nh, nl = int(mv["num_heads"]), int(mv["num_layers"])
        r = self.rate("motion_vae")

        def layer(x, p):
            h = self.layer_norm(x, f"{p}.norm1")
            x = x + self.drop(self.mha(f"{p}.self_attn", h, h, nh, rate=r),
                              r)
            if memory is not None:
                h = self.layer_norm(x, f"{p}.norm2")
                x = x + self.drop(self.mha(f"{p}.multihead_attn", h, memory,
                                           nh, rate=r), r)
            last = 3 if memory is not None else 2
            return x + self.drop(self.ffn(self.layer_norm(
                x, f"{p}.norm{last}"), p, r), r)

        xs = []
        for j in range((nl - 1) // 2):
            x = layer(x, f"{prefix}.input_blocks.{j}")
            xs.append(x)
        x = layer(x, f"{prefix}.middle_block")
        for j in range((nl - 1) // 2):
            x = self.linear(torch.cat([x, xs.pop()], -1),
                            f"{prefix}.linear_blocks.{j}")
            x = layer(x, f"{prefix}.output_blocks.{j}")
        return self.layer_norm(x, f"{prefix}.norm")

    def vae_encode(self, motion, eps):
        """motion (B, T, 189) -> (latent, mu, logvar), each (2, B, T/16,
        D); ``eps`` of that shape draws the sample."""
        b, t, nf = motion.shape
        nc = t // CHUNK
        x = motion.reshape(b * nc, CHUNK, nf)
        root = x[:, :1, :3] * torch.tensor([1.0, 0.0, 1.0], device=self.dev)
        x = torch.cat([x[:, :, :3] - root, x[:, :, 3:]], -1)
        d = int(self.cfg["latent_dim"][1])
        ls = int(self.cfg["latent_dim"][0])
        pe = sine_table(1024, d, self.dev)
        mus, lvs = [], []
        for part, feats in (("body", x[:, :, :BODY_NFEATS]),
                            ("hands", x[:, :, BODY_NFEATS:])):
            tok = self.P[f"vae.{part}_global_motion_token"]
            emb = self.linear(feats, f"vae.{part}_skel_embedding")
            seq = torch.cat([tok.expand(b * nc, -1, -1), emb], 1)
            out = self.skip_stack(seq + pe[:seq.shape[1]],
                                  f"vae.{part}_encoder")
            mus.append(out[:, :ls])
            lvs.append(out[:, ls:2 * ls])
        mu = torch.stack(mus).reshape(2, b, nc, -1)
        logvar = torch.stack(lvs).reshape(2, b, nc, -1)
        return mu + torch.exp(0.5 * logvar) * eps, mu, logvar

    def vae_decode(self, z, nframes):
        """z (2, B, n_chunks, D) -> motion (B, nframes, 189)."""
        _, b, nc, d = z.shape
        pe = sine_table(1024, d, self.dev)
        q = torch.zeros(b, nframes, d, device=self.dev) + pe[:nframes]
        parts = [self.linear(self.skip_stack(q, f"vae.{part}_decoder",
                                             z[i] + pe[:nc]),
                             f"vae.{part}_final_layer")
                 for i, part in enumerate(("body", "hands"))]
        return torch.cat(parts, -1)


# ---------------------------------------------------------------- sampling
def ddim_timesteps(n_train: int, n_steps: int) -> List[Tuple[int, int]]:
    """(t, t_prev) pairs, 'leading' spacing, descending."""
    ratio = n_train // n_steps
    return [(i * ratio, i * ratio - ratio) for i in range(n_steps - 1, -1, -1)]


def ddim_step(eps, lat, acp_t: float, acp_prev: float):
    """Deterministic DDIM (eta 0) with x0 clipped to [-1, 1]."""
    x0 = ((lat - math.sqrt(1 - acp_t) * eps) / math.sqrt(acp_t)).clamp(-1, 1)
    eps2 = (lat - math.sqrt(acp_t) * x0) / math.sqrt(1 - acp_t)
    return math.sqrt(acp_prev) * x0 + math.sqrt(1 - acp_prev) * eps2


def uncond_mel(frames: int, n_mels: int, device) -> torch.Tensor:
    mel = torch.full((1, frames, n_mels), -90.0, device=device)
    mel[..., 40:45] = 0.0
    return mel


@torch.no_grad()
def sample(ref: Ref, inputs: Dict, init_noise: torch.Tensor,
           rows: Sequence[int] | None = None, block: int = 32):
    """Guided DDIM sampling of ``inputs`` (token ids and validity masks of
    both texts and the uncond text, mel (B, T, 80), apb (B, 8), lsn_id
    (B,)) from ``init_noise`` (B, 16, D), then the VAE decode.  Runs
    ``block`` rows at a time.  Returns (motion (B, 128, 189), latents)."""
    cfg = ref.cfg
    sch = cfg["scheduler"]
    if sch["variant"] != "ddim" or float(sch["eta"]) != 0.0 or \
            not sch["clip_sample"] or not cfg["predict_epsilon"]:
        raise ValueError("the reference samples eta-0 DDIM with clipping "
                         "and epsilon prediction")
    acp = alphas_cumprod(sch)
    steps = ddim_timesteps(int(sch["num_train_timesteps"]),
                           int(sch["num_inference_timesteps"]))
    b = init_noise.shape[0]
    rows = list(range(b)) if rows is None else list(rows)
    mel = inputs["mel"]
    cond_u, pads_u = ref.conditions(
        inputs["uncond_ids"][:1], inputs["uncond_valid"][:1],
        inputs["uncond_ids"][:1], inputs["uncond_valid"][:1],
        uncond_mel(mel.shape[1], mel.shape[2], ref.dev),
        torch.full_like(inputs["apb"][:1], 2),
        torch.zeros_like(inputs["lsn_id"][:1]))
    motions, lats = [], []
    for lo in range(0, len(rows), block):
        idx = torch.tensor(rows[lo:lo + block], device=ref.dev)
        cond, pads = ref.conditions(
            inputs["spk_ids"][idx], inputs["spk_valid"][idx],
            inputs["lsn_ids"][idx], inputs["lsn_valid"][idx],
            mel[idx], inputs["apb"][idx], inputs["lsn_id"][idx])
        lat = init_noise[idx].float()
        for t, tp in steps:
            eps = ref.guided_eps(lat, t, cond, pads, cond_u, pads_u)
            lat = ddim_step(eps, lat, float(acp[t]),
                            float(acp[tp]) if tp >= 0 else 1.0)
        motions.append(decode(ref, lat))
        lats.append(lat)
    return torch.cat(motions), torch.cat(lats)


@torch.no_grad()
def decode(ref: Ref, latents: torch.Tensor) -> torch.Tensor:
    """Final latents (B, 16, D), the body and hands tokens of each chunk
    interleaved, -> motion (B, max_len, 189) through the VAE decode."""
    n = latents.shape[0]
    z = latents.reshape(n, -1, 2, latents.shape[-1]).permute(2, 0, 1, 3)
    return ref.vae_decode(z, int(ref.cfg["max_len"]))


# ---------------------------------------------------------------- training
def smooth_l1(a, b):
    d = (a - b).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def laplace_time(x, size: int):
    k = torch.ones(size, device=x.device)
    k[size // 2] = 1.0 - size
    b, t, f = x.shape
    out = F.conv1d(x.transpose(1, 2).reshape(b * f, 1, t), k[None, None])
    return out.reshape(b, f, -1).transpose(1, 2)


def bone_variance(motion, bones):
    pairs = torch.tensor([(a, c) for a, c in bones if a != 0],
                         device=motion.device)
    b, t, nf = motion.shape
    pts = motion.reshape(b, t, nf // 3, 3)
    d = pts[:, :, pairs[:, 0]] - pts[:, :, pairs[:, 1]]
    return torch.sqrt(d.square().sum(-1) + 1e-12).var(dim=1).mean()


def vae_loss(ref: Ref, motion, eps):
    """Stage 1: weighted smooth-L1 recon, KL, Laplace recon and bone-length
    variance of the reconstruction."""
    w = ref.cfg["train"]["loss"]
    latent, mu, logvar = ref.vae_encode(motion, eps)
    recon = ref.vae_decode(latent, motion.shape[1])
    cw = channel_weights(motion.shape[2], ref.dev)
    rec = (smooth_l1(recon, motion) * cw[0]).mean()
    kl = (0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar)).mean()
    total = float(w["lambda_rec"]) * rec + float(w["lambda_kl"]) * kl
    k = int(ref.cfg["train"]["laplace_kernel_size"])
    if k:
        lap = (smooth_l1(laplace_time(recon, k), laplace_time(motion, k))
               * cw[1]).mean()
        total = total + float(w["lambda_rec"]) * lap
    if float(w.get("lambda_bl", 0.0)):
        total = total + float(w["lambda_bl"]) * bone_variance(
            recon, ref.cfg["train"]["bones"])
    return total


def diffusion_loss(ref: Ref, batch, draws):
    """Stage 2: the frozen VAE's sample of the listener's motion is noised
    at per-row timesteps; each row keeps the conditions of its
    modality-dropout group; MSE of the predicted noise."""
    cfg = ref.cfg
    w = cfg["train"]["loss"]
    for k in ("lambda_latent", "lambda_prior", "lambda_guided_attention"):
        if float(w.get(k, 0.0)):
            raise ValueError(f"the reference has no {k} term")
    if float(cfg["text_encoder"].get("dropout", 0.0)):
        raise ValueError("the reference's T5 trunk has no dropout")
    frozen = Ref(ref.P, cfg, ref.lowp)      # eval: no dropout
    with torch.no_grad():
        latent, _, _ = frozen.vae_encode(batch["motion"], draws["eps"])
        b = latent.shape[1]
        z = latent.permute(1, 2, 0, 3).reshape(b, -1, latent.shape[-1])
        keep = {s: torch.tensor([s in GUIDANCE_BRANCHES[int(g)]
                                 for g in draws["group"].tolist()],
                                device=ref.dev) for s in COND_STREAMS}
        kt, ks = keep["tlsn"][:, None], keep["spkemb"][:, None]
        lsn_ids = torch.where(kt, batch["lsn_ids"], batch["uncond_ids"])
        spk_ids = torch.where(ks, batch["spk_ids"], batch["uncond_ids"])
        lsn_valid = torch.where(kt, batch["lsn_valid"], batch["uncond_valid"])
        spk_valid = torch.where(ks, batch["spk_valid"], batch["uncond_valid"])
        mel = batch["mel"]
        mel = torch.where(keep["alsn"][:, None, None], mel,
                          uncond_mel(mel.shape[1], mel.shape[2], ref.dev))
        apb = torch.where(keep["apb"][:, None], batch["apb"], 2)
        lsn_id = torch.where(keep["lsnemb"], batch["lsn_id"], 0)
        # the trunk is frozen: only its projection trains
        trunk_spk = frozen.t5(spk_ids, spk_valid)
        trunk_lsn = frozen.t5(lsn_ids, lsn_valid)
    proj = "text_encoder.projection.1"
    cond = {"spkemb": ref.linear(F.relu(trunk_spk), proj),
            "alsn": ref.audio(mel),
            "tlsn": ref.linear(F.relu(trunk_lsn), proj),
            "apb": ref.P["condition_fuser.active_passive_emb.weight"][apb],
            "lsnemb": ref.P["condition_fuser.lsn_id_emb.weight"][
                lsn_id][:, None]}
    pads = {"spkemb": ~spk_valid, "tlsn": ~lsn_valid}
    acp = torch.from_numpy(alphas_cumprod(cfg["noise_scheduler"])).float().to(
        ref.dev)[draws["timesteps"]][:, None, None]
    noisy = acp.sqrt() * z + (1 - acp).sqrt() * draws["noise"]
    pred = ref.denoise(noisy, draws["timesteps"], cond, pads)
    return ((pred - draws["noise"]) ** 2).mean()


def adamw_steps(P0: Dict[str, torch.Tensor], cfg: Dict, stage: str,
                batches, draws, lowp: str | None = None,
                mask_seed: int | None = None):
    """Train from the weights ``P0`` for ``len(batches)`` AdamW steps
    (optax semantics, fp32), the dropout masks of every step drawn in turn
    from one generator seeded with ``mask_seed`` on the weights' device
    (none without it).  Returns (losses, the first step's gradient per
    trainable leaf, each trainable leaf's change after the first step,
    and after all of them)."""
    optim = cfg["train"]["optim"]
    if str(optim.get("schedule", "constant")) != "constant" or \
            float(optim.get("grad_clip", 0.0)):
        raise ValueError("the reference steps a constant rate, no clip")
    lr, wd = float(optim["lr"]), float(optim["weight_decay"])
    names = [n for n in P0 if trainable(n, stage)]
    P = {n: (p.clone().requires_grad_(True) if n in names else p)
         for n, p in P0.items()}
    mu = {n: torch.zeros_like(P0[n]) for n in names}
    nu = {n: torch.zeros_like(P0[n]) for n in names}
    masks = None
    if mask_seed is not None:
        dev = next(iter(P0.values())).device
        masks = torch.Generator(device=dev).manual_seed(int(mask_seed))
    losses, first, change1 = [], None, None
    for step, (batch, dr) in enumerate(zip(batches, draws), start=1):
        ref = Ref(P, cfg, lowp, masks)
        loss = (vae_loss(ref, batch["motion"], dr["eps"]) if stage == "vae"
                else diffusion_loss(ref, batch, dr))
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(P0[n]) if g is None else g.detach()
                 for n, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        bc1, bc2 = 1 - ADAM_B1 ** step, 1 - ADAM_B2 ** step
        with torch.no_grad():
            for n in names:
                mu[n].mul_(ADAM_B1).add_(grads[n], alpha=1 - ADAM_B1)
                nu[n].mul_(ADAM_B2).addcmul_(grads[n], grads[n],
                                             value=1 - ADAM_B2)
                upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + ADAM_EPS)
                P[n].sub_(lr * (upd + wd * P[n]))
        if change1 is None:
            change1 = {n: (P[n].detach() - P0[n]) for n in names}
    change = {n: (P[n].detach() - P0[n]) for n in names}
    return losses, first, change1, change
