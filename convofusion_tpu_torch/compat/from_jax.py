"""JAX parameter tree -> port state_dict.

``state_dict_from_jax(params)`` takes the tree ``convofusion_tpu``'s
``Convofusion.init_params`` returns (nested dicts of arrays under ``vae``,
``denoiser``, ``text_encoder``, ``audio_encoder``, ``condition_fuser``) and
returns the port ``Convofusion``'s state_dict: flax ``kernel`` (in, out)
becomes ``weight`` (out, in), LayerNorm ``scale`` becomes ``weight``,
``embedding`` becomes ``weight``, and the q/k/v projections pack into
``in_proj_weight``/``in_proj_bias``; a fused-stream layer's
``cross_streams`` keeps its stacked layout and names
(``ops/fused_streams.py``).  Every leaf must be consumed: a key it does not
know raises.  A stage-1 tree (``vae`` alone) gives the state_dict of
``Convofusion(..., stage='vae')``; a tree without ``vae`` that of a model
on raw motion (``vae_type`` 'no'); any other tree must hold every
module.  The ablations' trees come across too: learned PE tables
(``pe``), the MLP_DIST heads, the all_encoder decoders, the trans_enc
``encoder`` and ``emb_proj`` (Dense -> ``emb_proj.1``, or the action
table).  ``module_state_dict_from_jax`` carries one module's tree, the
``TextAudioController`` and ``EmbedAction`` included.  The map is linear
(transposes and concatenations), so it carries a gradient tree as it
carries parameters.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from convofusion_tpu_torch.ops.transformer import COND_STREAMS


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


class _Converter:
    def __init__(self, flat):
        self.flat = flat
        self.used = set()
        self.sd: Dict[str, torch.Tensor] = {}

    def take(self, path):
        if path not in self.flat:
            raise KeyError(f"JAX parameter {path!r} missing")
        self.used.add(path)
        return self.flat[path]

    def has(self, path):
        return path in self.flat

    def count(self, prefix):
        """Number of numbered children ``{prefix}{i}/`` present."""
        n = 0
        while any(k.startswith(f"{prefix}{n}/") for k in self.flat):
            n += 1
        return n

    def put(self, key, arr):
        self.sd[key] = torch.from_numpy(np.array(arr, np.float32))

    def dense(self, path, key):
        self.put(f"{key}.weight", self.take(f"{path}/kernel").T)
        if self.has(f"{path}/bias"):
            self.put(f"{key}.bias", self.take(f"{path}/bias"))

    def layernorm(self, path, key):
        self.put(f"{key}.weight", self.take(f"{path}/scale"))
        self.put(f"{key}.bias", self.take(f"{path}/bias"))

    def embed(self, path, key):
        self.put(f"{key}.weight", self.take(f"{path}/embedding"))

    def mha(self, path, key):
        parts = ("q_proj", "k_proj", "v_proj")
        self.put(f"{key}.in_proj_weight", np.concatenate(
            [self.take(f"{path}/{p}/kernel").T for p in parts]))
        self.put(f"{key}.in_proj_bias", np.concatenate(
            [self.take(f"{path}/{p}/bias") for p in parts]))
        self.dense(f"{path}/out_proj", f"{key}.out_proj")

    def ffn(self, path, key):
        self.dense(f"{path}/ffn/linear1", f"{key}.linear1")
        self.dense(f"{path}/ffn/linear2", f"{key}.linear2")

    def time_block(self, path, key):
        self.dense(f"{path}/emb_layers_1", f"{key}.emb_layers.1")
        self.dense(f"{path}/out_layers_2", f"{key}.out_layers.2")
        self.layernorm(f"{path}/norm", f"{key}.norm")

    def learned_pe(self, path, key):
        """A learned PE's table, where the tree has one (a sine PE has no
        parameters)."""
        if self.has(f"{path}/pe"):
            self.put(f"{key}.pe", self.take(f"{path}/pe"))

    # ---------------------------------------------------------- modules
    def denoiser(self, p="denoiser", k="denoiser"):
        self.dense(f"{p}/latent_embd", f"{k}.latent_embd")
        self.dense(f"{p}/latent_proj", f"{k}.latent_proj")
        for lin in ("linear_1", "linear_2"):
            self.dense(f"{p}/time_embedding/{lin}",
                       f"{k}.time_embedding.{lin}")
        self.embed(f"{p}/bh_embedding", f"{k}.bh_embedding")
        if self.has(f"{p}/emb_proj/action_embedding"):
            self.put(f"{k}.emb_proj.action_embedding",
                     self.take(f"{p}/emb_proj/action_embedding"))
        elif self.has(f"{p}/emb_proj/kernel"):
            self.dense(f"{p}/emb_proj", f"{k}.emb_proj.1")
        if self.count(f"{p}/encoder/input_blocks_") or self.has(
                f"{p}/encoder/norm/scale"):
            # trans_enc: a skip encoder, no decoder, condition embedding
            # or memory PE
            self.skip_stack(f"{p}/encoder", f"{k}.encoder", cross=False)
            return
        self.learned_pe(f"{p}/mem_pos", f"{k}.mem_pos")
        self.embed(f"{p}/condition_embedding", f"{k}.condition_embedding")
        dp, dk = f"{p}/decoder", f"{k}.decoder"
        self.layernorm(f"{dp}/norm", f"{dk}.norm")
        for i in range(self.count(f"{dp}/layers_")):
            lp, lk = f"{dp}/layers_{i}", f"{dk}.layers.{i}"
            self.mha(f"{lp}/self_attn", f"{lk}.self_attn")
            self.time_block(f"{lp}/time_block1", f"{lk}.time_block1")
            self.time_block(f"{lp}/time_block2", f"{lk}.time_block2")
            self.dense(f"{lp}/att_fuser", f"{lk}.att_fuser")
            self.ffn(lp, lk)
            for n in ("norm1", "norm2", "norm3"):
                self.layernorm(f"{lp}/{n}", f"{lk}.{n}")
            if self.has(f"{lp}/cross_streams/ln_scale"):
                self.cross_streams(f"{lp}/cross_streams",
                                   f"{lk}.cross_streams")
                continue
            for s in COND_STREAMS:
                self.mha(f"{lp}/multihead_attn_{s}",
                         f"{lk}.multihead_attn_{s}")
                self.layernorm(f"{lp}/{s}_norm", f"{lk}.{s}_norm")

    def cross_streams(self, p, k):
        """A fused layer's stacked cross-attention weights, as they are."""
        names = ["ln_scale", "ln_bias"] + [
            f"{q}_{w}" for q in "qkvo" for w in ("kernel", "bias")]
        for n in names:
            self.put(f"{k}.{n}", self.take(f"{p}/{n}"))

    def skip_stack(self, p, k, cross: bool):
        """A skip encoder (``cross`` False: self-attention, 2 norms) or
        decoder (cross-attention too, 3 norms)."""
        self.layernorm(f"{p}/norm", f"{k}.norm")
        blocks = [("middle_block", "middle_block")]
        for i in range(self.count(f"{p}/input_blocks_")):
            blocks += [(f"input_blocks_{i}", f"input_blocks.{i}"),
                       (f"output_blocks_{i}", f"output_blocks.{i}")]
            self.dense(f"{p}/linear_blocks_{i}", f"{k}.linear_blocks.{i}")
        for jp, tk in blocks:
            self.layer(f"{p}/{jp}", f"{k}.{tk}", cross)

    def layer(self, p, k, cross: bool):
        """A ``TransformerEncoderLayer`` (``cross`` False) or
        ``TransformerDecoderLayer``."""
        self.mha(f"{p}/self_attn", f"{k}.self_attn")
        if cross:
            self.mha(f"{p}/multihead_attn", f"{k}.multihead_attn")
        self.ffn(p, k)
        for n in ("norm1", "norm2", "norm3")[:3 if cross else 2]:
            self.layernorm(f"{p}/{n}", f"{k}.{n}")

    def encoder_layer(self, p, k):
        self.layer(p, k, cross=False)

    def decoder_layer(self, p, k):
        self.layer(p, k, cross=True)

    def vae(self, p="vae", k="vae"):
        for pe in ("query_pos_encoder", "query_pos_decoder",
                   "mem_pos_decoder"):
            self.learned_pe(f"{p}/{pe}", f"{k}.{pe}")
        for part in ("body", "hands"):
            self.skip_stack(f"{p}/{part}_encoder", f"{k}.{part}_encoder",
                            cross=False)
            # all_encoder's decoders are skip encoders (no cross-attention)
            dec = f"{p}/{part}_decoder"
            self.skip_stack(dec, f"{k}.{part}_decoder", cross=self.has(
                f"{dec}/middle_block/multihead_attn/out_proj/kernel"))
            self.dense(f"{p}/{part}_skel_embedding",
                       f"{k}.{part}_skel_embedding")
            self.dense(f"{p}/{part}_final_layer", f"{k}.{part}_final_layer")
            if self.has(f"{p}/{part}_dist_layer/kernel"):     # MLP_DIST
                self.dense(f"{p}/{part}_dist_layer", f"{k}.{part}_dist_layer")
            name = f"{part}_global_motion_token"
            self.put(f"{k}.{name}", self.take(f"{p}/{name}"))

    def text_encoder(self, p="text_encoder", k="text_encoder"):
        tp, tk = f"{p}/text_model", f"{k}.text_model.encoder"
        self.embed(f"{tp}/embed_tokens", f"{tk}.embed_tokens")
        self.put(f"{tk}.final_layer_norm.weight",
                 self.take(f"{tp}/final_layer_norm/weight"))
        for i in range(self.count(f"{tp}/block_")):
            bp, bk = f"{tp}/block_{i}", f"{tk}.block.{i}.layer"
            for n in ("q", "k", "v", "o"):
                self.dense(f"{bp}/attention/{n}",
                           f"{bk}.0.SelfAttention.{n}")
            if self.has(f"{bp}/attention/relative_attention_bias/embedding"):
                self.embed(f"{bp}/attention/relative_attention_bias",
                           f"{bk}.0.SelfAttention.relative_attention_bias")
            self.put(f"{bk}.0.layer_norm.weight",
                     self.take(f"{bp}/attn_norm/weight"))
            self.put(f"{bk}.1.layer_norm.weight",
                     self.take(f"{bp}/ff_norm/weight"))
            self.dense(f"{bp}/wi", f"{bk}.1.DenseReluDense.wi")
            self.dense(f"{bp}/wo", f"{bk}.1.DenseReluDense.wo")
        self.dense(f"{p}/projection_1", f"{k}.projection.1")

    def audio_encoder(self, p="audio_encoder", k="audio_encoder"):
        self.dense(f"{p}/main_0", f"{k}.main.0")
        self.dense(f"{p}/main_3", f"{k}.main.3")
        self.dense(f"{p}/out_net", f"{k}.out_net")

    def controller(self, p, k):
        """``TextAudioController``: the audio encoder and the spk-ta
        projections."""
        self.audio_encoder(f"{p}/audio_encoder", f"{k}.audio_encoder")
        for name in ("text_time_proj", "audio_time_proj", "out_net"):
            self.dense(f"{p}/{name}", f"{k}.{name}")

    def condition_fuser(self):
        for n in ("active_passive_emb", "lsn_id_emb"):
            self.embed(f"condition_fuser/{n}", f"condition_fuser.{n}")


def _finish(conv: _Converter) -> Dict[str, torch.Tensor]:
    unknown = sorted(k for k in conv.flat if k not in conv.used)
    if unknown:
        raise KeyError(f"JAX parameters with no port counterpart: "
                       f"{unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    return conv.sd


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``Convofusion`` parameter tree -> port ``Convofusion``
    state_dict (fp32 tensors on the CPU)."""
    conv = _Converter(_flatten(params))
    if "vae" in params:
        conv.vae()
    if set(params) - {"vae"}:
        conv.denoiser()
        conv.text_encoder()
        conv.audio_encoder()
        conv.condition_fuser()
    return _finish(conv)


# module -> the converter method that carries its tree
MODULES = ("vae", "denoiser", "audio_encoder", "controller", "embed_action",
           "encoder_layer", "decoder_layer")


def module_state_dict_from_jax(kind: str, params) -> Dict[str, torch.Tensor]:
    """One module's JAX parameter tree (``module.init(...)['params']``) ->
    the port module's state_dict: ``kind`` is one of :data:`MODULES`
    (``ConvoFusionVae``, ``Denoiser``, ``AudioConvEncoder``,
    ``TextAudioController``, ``EmbedAction``, ``TransformerEncoderLayer``,
    ``TransformerDecoderLayer``)."""
    if kind not in MODULES:
        raise ValueError(f"module {kind!r}, not one of {MODULES}")
    conv = _Converter(_flatten({"m": params}))
    if kind == "embed_action":
        conv.put("m.action_embedding", conv.take("m/action_embedding"))
    else:
        getattr(conv, kind)("m", "m")
    return {key[2:]: v for key, v in _finish(conv).items()}
