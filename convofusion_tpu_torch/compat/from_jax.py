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
module.  The map is linear (transposes and concatenations), so it carries
a gradient tree as it carries parameters.
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

    # ---------------------------------------------------------- modules
    def denoiser(self, p="denoiser", k="denoiser"):
        self.dense(f"{p}/latent_embd", f"{k}.latent_embd")
        self.dense(f"{p}/latent_proj", f"{k}.latent_proj")
        for lin in ("linear_1", "linear_2"):
            self.dense(f"{p}/time_embedding/{lin}",
                       f"{k}.time_embedding.{lin}")
        self.embed(f"{p}/bh_embedding", f"{k}.bh_embedding")
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
            lp, lk = f"{p}/{jp}", f"{k}.{tk}"
            self.mha(f"{lp}/self_attn", f"{lk}.self_attn")
            if cross:
                self.mha(f"{lp}/multihead_attn", f"{lk}.multihead_attn")
            self.ffn(lp, lk)
            for n in ("norm1", "norm2", "norm3")[:3 if cross else 2]:
                self.layernorm(f"{lp}/{n}", f"{lk}.{n}")

    def vae(self):
        for part in ("body", "hands"):
            self.skip_stack(f"vae/{part}_encoder", f"vae.{part}_encoder",
                            cross=False)
            self.skip_stack(f"vae/{part}_decoder", f"vae.{part}_decoder",
                            cross=True)
            self.dense(f"vae/{part}_skel_embedding",
                       f"vae.{part}_skel_embedding")
            self.dense(f"vae/{part}_final_layer", f"vae.{part}_final_layer")
            name = f"{part}_global_motion_token"
            self.put(f"vae.{name}", self.take(f"vae/{name}"))

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

    def audio_encoder(self):
        self.dense("audio_encoder/main_0", "audio_encoder.main.0")
        self.dense("audio_encoder/main_3", "audio_encoder.main.3")
        self.dense("audio_encoder/out_net", "audio_encoder.out_net")

    def condition_fuser(self):
        for n in ("active_passive_emb", "lsn_id_emb"):
            self.embed(f"condition_fuser/{n}", f"condition_fuser.{n}")


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
    unknown = sorted(k for k in conv.flat if k not in conv.used)
    if unknown:
        raise KeyError(f"JAX parameters with no port counterpart: "
                       f"{unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    return conv.sd
