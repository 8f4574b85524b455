"""ConvoFusion in PyTorch for NVIDIA Hopper, beside the JAX package.

Layers, entry point down to the device (each module's counterpart keeps its
path in ``convofusion_tpu/``):

  serving.py              GestureService (micro-batching, three threads),
                          serve_http, build_service, the CLI
  models/convofusion.py   Convofusion.sample: encode -> reverse -> decode;
                          CachedSampler
  models/weg.py           word-excitation guidance (loss, refinement)
  models/t5.py, audioenc.py, condfuser.py
                          condition encoders (T5 trunk x2, mel MLP, fuser)
  models/denoiser.py      7-branch guided denoiser
  models/vae.py           chunked body/hands VAE decoder
  diffusion/schedulers.py DDPM / DDIM tables and the plain step
  ops/                    attention, transformer blocks, embeddings,
                          positional encodings, smoothing kernel, the
                          fused step kernel
  csrc/                   hand-written CUDA kernels (sm_90a)
  compat/from_jax.py      JAX parameter tree -> port state_dict
  data/synthetic.py       seeded synthetic batches

The package imports torch and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no device given
they raise.
"""
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a missing card is an error, never a quiet
    fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype) -> torch.dtype:
    """Compute dtype from a torch dtype or its config name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPES.values():
            raise ValueError(f"unsupported compute dtype {dtype}")
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return DTYPES[dtype]
