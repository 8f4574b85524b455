"""Checkpoints: save, load and resume, the stage-1 -> stage-2 handoff, and
released reference ``.ckpt`` files.

The semantics of ``convofusion_tpu/train/checkpoint.py``, with
``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax:

* one file, ``<dir>/epoch=<step>.ckpt``, a dict holding
  - ``state_dict``: the weights in fp32 under the reference's names (the
    port's top-level ``text_encoder.`` / ``audio_encoder.`` nest under
    ``text_audio_encoder.``, :313-325), without the frozen T5 trunk unless
    asked (:79-86).  Where a trainer is given, its fp32 masters stand for
    the weights it trains; the lower-precision weights are their rounding;
  - ``trainer`` (optional): the masters, the AdamW moments ``mu`` and ``nu``
    and the step ``count``, by the port's parameter names;
  - ``generator`` (optional): the state of the step generator.
  The JAX package's ``load_torch_full_model`` / ``load_torch_vae`` read
  ``obj["state_dict"]`` and ignore the rest (:197-205): a port checkpoint
  is a reference checkpoint.
* loading re-injects the live trunk where the file has none (:89-102) and
  restores the trainer and the generator when asked (:120-167).
"""
from __future__ import annotations

import os
import re
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import torch

from convofusion_tpu_torch.utils.assets import asset_path

# the frozen T5 trunk, by the port's names
TRUNK = "text_encoder.text_model."
# the port's top-level module names -> the reference checkpoint's
_REFERENCE_PREFIXES = (
    ("text_encoder.", "text_audio_encoder.text_encoder."),
    ("audio_encoder.", "text_audio_encoder.audio_encoder."),
)

# background writes in flight and the errors they met, for
# wait_for_checkpoints (the writer threads and the caller share them)
_lock = threading.Lock()
_pending: List[threading.Thread] = []
_errors: List[Exception] = []


def _to_reference_names(sd: Dict) -> Dict:
    """Port names -> the reference checkpoint's."""
    out = {}
    for k, v in sd.items():
        for ours, ref in _REFERENCE_PREFIXES:
            if k.startswith(ours):
                k = ref + k[len(ours):]
                break
        out[k] = v
    return out


def _from_reference_names(sd: Dict) -> Dict:
    """The reference checkpoint's names -> the port's."""
    out = {}
    for k, v in sd.items():
        for ours, ref in _REFERENCE_PREFIXES:
            if k.startswith(ref):
                k = ours + k[len(ref):]
                break
        out[k] = v
    return out


def strip_frozen_text_model(sd: Dict) -> Dict:
    """Drop the frozen T5 trunk before writing (port names, :79-86)."""
    return {k: v for k, v in sd.items() if not k.startswith(TRUNK)}


def _checkpoint_state(model, trainer=None, generator=None,
                     keep_text_model: bool = False) -> Dict:
    """What :func:`save_checkpoint` writes, every tensor copied to host
    memory (fp32 weights; a master and its weight share one copy)."""
    masters = {} if trainer is None or trainer.state is None else dict(
        zip(trainer.names, trainer.masters))
    weights = {k: masters.get(k, v) for k, v in model.state_dict().items()}
    if not keep_text_model:
        weights = strip_frozen_text_model(weights)
    copies = {}

    def host(t):
        if id(t) not in copies:
            copies[id(t)] = t.detach().to("cpu", torch.float32, copy=True)
        return copies[id(t)]

    obj = {"state_dict": _to_reference_names(
        {k: host(v) for k, v in weights.items()})}
    if masters:
        state = trainer.state_dict()
        obj["trainer"] = {
            "masters": {n: host(t) for n, t in state["masters"].items()},
            "mu": {n: host(t) for n, t in state["mu"].items()},
            "nu": {n: host(t) for n, t in state["nu"].items()},
            "count": int(state["count"])}
    if generator is not None:
        obj["generator"] = generator.get_state()
    return obj


def _write(obj: Dict, path: Path) -> None:
    """Write through a temporary file, so a reader never sees half a
    checkpoint."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_in_background(obj: Dict, path: Path) -> None:
    try:
        _write(obj, path)
    except Exception as e:  # re-raised by wait_for_checkpoints
        with _lock:
            _errors.append(e)


def save_checkpoint(ckpt_dir: str, step: int, model, trainer=None,
                    generator: Optional[torch.Generator] = None,
                    keep_text_model: bool = False,
                    background: bool = False) -> str:
    """Write ``<ckpt_dir>/epoch=<step>.ckpt`` (:105-117) and return its
    path.  With ``background`` the tensors are on the host when the call
    returns and a thread writes them: call :func:`wait_for_checkpoints`
    before reading the file or exiting."""
    path = Path(ckpt_dir) / f"epoch={step}.ckpt"
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = _checkpoint_state(model, trainer, generator, keep_text_model)
    if background:
        th = threading.Thread(target=_write_in_background, args=(obj, path),
                              name=f"checkpoint {path.name}")
        th.start()
        with _lock:
            _pending.append(th)
    else:
        _write(obj, path)
    return str(path)


def wait_for_checkpoints() -> None:
    """Block until every background write is on disk (:73-76); raise the
    first error a write met."""
    with _lock:
        threads = list(_pending)
        _pending.clear()
    for th in threads:
        th.join()
    with _lock:
        errors = list(_errors)
        _errors.clear()
    if errors:
        raise RuntimeError(f"{len(errors)} background checkpoint write(s) "
                           f"failed") from errors[0]


def _read(path: str) -> Dict:
    """The file's dict; a bare state dict becomes ``{"state_dict": sd}``
    (:197-205)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a checkpoint dict")
    return obj if "state_dict" in obj else {"state_dict": obj}


def _tensors(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _load_weights(model, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Copy the file's weights (port names) into every module ``model``
    builds, in the model's dtypes.  Every weight of those modules must be
    there, except the frozen trunk, which stays the live one when the file
    has none (:89-102); a module the model does not build is skipped."""
    own = model.state_dict()
    modules = {k.split(".")[0] for k in own}
    sd = {k: v for k, v in sd.items() if k.split(".")[0] in modules}
    missing = [k for k in own if k not in sd and not k.startswith(TRUNK)]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"{what}: the file does not fit the model: "
                       f"{len(missing)} weights missing {missing[:3]}, "
                       f"{len(unexpected)} unknown {unexpected[:3]}")
    model.load_state_dict(sd, strict=False)


def load_checkpoint(path: str, model, trainer=None,
                    generator: Optional[torch.Generator] = None) -> None:
    """Load a port or reference checkpoint into ``model`` (:120-167).

    With ``trainer``, its masters, moments and count come back from the
    file; a trainer state whose names or shapes differ from the trainer's
    warns and resumes with the parameters only (fresh moments), as JAX
    does, its fp32 masters then the file's fp32 weights.  With
    ``generator``, its state comes back where the file has one."""
    obj = _read(path)
    weights = _from_reference_names(_tensors(obj["state_dict"]))
    _load_weights(model, weights, str(path))
    if trainer is not None:
        state = obj.get("trainer")
        try:
            if state is None:
                raise KeyError("the file holds no trainer state")
            trainer.load_state_dict(state)
        except (KeyError, ValueError) as e:
            warnings.warn(f"optimizer state in {path} does not match the "
                          f"trainer ({e!r}); resuming with params only")
            trainer.init_state(weights)
    if generator is not None and "generator" in obj:
        generator.set_state(obj["generator"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest ``epoch=`` entry of ``ckpt_dir`` (:170-180)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.match(r"epoch=(\d+)", name)
        if m and not name.endswith(".tmp") and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


# ------------------------------------------------ reference checkpoints
def _infer_skip_layers(sd: Dict, prefix: str) -> int:
    """SkipTransformer num_layers from the highest input_blocks index
    (:253-264)."""
    idx = [int(m.group(1)) for k in sd if (m := re.match(
        rf"{re.escape(prefix)}\.input_blocks\.(\d+)\.", k))]
    if not idx:
        raise KeyError(f"no '{prefix}.input_blocks.*' keys in the "
                       f"checkpoint: an unexpected key prefix (e.g. "
                       f"'module.')?")
    return 2 * (max(idx) + 1) + 1


def _check_dims(what: str, found: Dict, model_cfg: Dict) -> None:
    bad = {k: (v, model_cfg[k]) for k, v in found.items()
           if int(v) != int(model_cfg[k])}
    if bad:
        raise ValueError(f"{what}: the checkpoint's dims differ from the "
                         f"model's (checkpoint, model): {bad}")


def _vae_state(sd: Dict) -> Dict:
    """The VAE's weights of a full (``vae.``-prefixed) or bare-VAE state
    dict (train.py:148-152), under ``vae.``."""
    if any(k.startswith("vae.") for k in sd):
        return {k: v for k, v in sd.items() if k.startswith("vae.")}
    return {f"vae.{k}": v for k, v in sd.items()}


def load_torch_vae(path: str, model) -> None:
    """A stage-1 checkpoint's VAE into ``model.vae`` (:267-283), its dims
    inferred from the file and checked against the model's."""
    sd = _vae_state(_tensors(_read(path)["state_dict"]))
    cfg = model.cfg
    _check_dims(f"{path} (VAE)", {
        "latent_dim": sd["vae.body_skel_embedding.weight"].shape[0],
        "num_layers": _infer_skip_layers(sd, "vae.body_encoder")},
        {"latent_dim": cfg["latent_dim"][1],
         "num_layers": cfg["motion_vae"]["num_layers"]})
    own = {k for k in model.state_dict() if k.startswith("vae.")}
    if set(sd) != own:
        raise KeyError(f"{path}: VAE weights differ from the model's: "
                       f"{sorted(set(sd) ^ own)[:4]}")
    model.load_state_dict(sd, strict=False)


def transplant_vae(model, vae_ckpt_path: str) -> None:
    """The stage handoff: a stage-1 checkpoint's VAE into a stage-2 model,
    nothing else (:183-193, reference train.py:144-156).  A model on raw
    motion has no VAE to take it: JAX adds the tree unused, the port warns
    and leaves the model as it is."""
    if model.vae is None:
        warnings.warn(f"{vae_ckpt_path}: the model diffuses raw motion "
                      f"(vae_type 'no'); its VAE is not loaded")
        return
    load_torch_vae(vae_ckpt_path, model)


def load_torch_full_model(path: str, model) -> None:
    """A released full reference checkpoint (or a port one) into
    ``model`` (:286-340): VAE, denoiser, audio encoder, fuser, the T5
    projection and, where the file has it, the T5 trunk.  The VAE's and the
    denoiser's dims are inferred from the file and checked against the
    model's.  A model on raw motion (no VAE) takes the rest of a file, and
    a file's weights that do not fit the model's layout (the unfused
    cross-attentions into a ``fuse_streams`` model) raise: no conversion
    is made, as JAX makes none."""
    sd = _from_reference_names(_tensors(_read(path)["state_dict"]))
    cfg = model.cfg
    layers = [int(m.group(1)) for k in sd if (m := re.match(
        r"denoiser\.decoder\.layers\.(\d+)\.", k))]
    found = {"denoiser_dim": sd["denoiser.latent_embd.weight"].shape[0],
             "denoiser_layers": 1 + max(layers, default=-1)}
    want = {"denoiser_dim": cfg["denoiser"]["text_encoded_dim"],
            "denoiser_layers": cfg["denoiser"]["num_layers"]}
    if model.vae is not None:
        found.update(
            vae_dim=sd["vae.body_skel_embedding.weight"].shape[0],
            vae_layers=_infer_skip_layers(sd, "vae.body_encoder"))
        want.update(vae_dim=cfg["latent_dim"][1],
                    vae_layers=cfg["motion_vae"]["num_layers"])
    _check_dims(str(path), found, want)
    _load_weights(model, sd, str(path))


def maybe_load_t5_assets(model) -> bool:
    """Real t5-base trunk weights from the asset drop
    (``utils/assets.py``: ``t5-base/pytorch_model.bin`` or
    ``model.safetensors``, HF names) into ``model``'s frozen trunk, as the
    reference's ``from_pretrained('t5-base')`` (:208-250).  A no-op
    returning False when the asset is absent or the model has no text
    encoder; warns and returns False when the geometry differs."""
    te = getattr(model, "text_encoder", None)
    path = (asset_path("t5-base/pytorch_model.bin")
            or asset_path("t5-base/model.safetensors"))
    if te is None or path is None:
        return False
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = _tensors(_read(path)["state_dict"])
    embed = sd.get("encoder.embed_tokens.weight", sd.get("shared.weight"))
    stack = te.text_model.encoder
    layers = 1 + max((int(m.group(1)) for k in sd if (m := re.match(
        r"encoder\.block\.(\d+)\.", k))), default=-1)
    if embed is None or tuple(embed.shape) != tuple(
            stack.embed_tokens.weight.shape) or layers != len(stack.block):
        warnings.warn(
            f"t5-base asset at {path} has embed shape "
            f"{None if embed is None else tuple(embed.shape)} and {layers} "
            f"layers, the model {tuple(stack.embed_tokens.weight.shape)} and "
            f"{len(stack.block)}; skipping injection (non-production "
            f"geometry)")
        return False
    trunk = {k[len("encoder."):]: v for k, v in sd.items()
             if k.startswith("encoder.")}
    trunk["embed_tokens.weight"] = embed
    stack.load_state_dict(trunk)
    model.weights_version += 1
    return True
