"""ConvoFusion in PyTorch for NVIDIA Hopper, beside the JAX package.

Layers, entry point down to the device (each module's counterpart keeps its
path in ``convofusion_tpu/``):

  serving.py              GestureService (micro-batching, three threads),
                          serve_http, build_service, the CLI
  cli/train.py            the training CLI: config -> datasets -> epochs
                          of Trainer steps (train/prefetch.py, the T5
                          trunk and VAE posterior caches, validation,
                          utils/metrics_logger.py, callback/progress.py)
                          -> epoch=<n>.ckpt files
  cli/test.py             the test CLI: config -> test split -> sample()
                          -> result directories with attention maps
  cli/unbounded.py        rollout: long-form synthesis in half-overlapping
                          windows (cli/focus.py: WEG focus words); main,
                          the rollout CLI
  eval/                   offline metrics over result dumps (FID net,
                          alignment, SRGR, L1div, diversity, jitter)
  models/convofusion.py   Convofusion.sample: encode -> reverse -> decode,
                          with preseq inpainting; CachedSampler
  models/results.py       per-sample result dumps
  models/tokenizer.py, sentencepiece.py
                          t5-base SentencePiece (pure Python), word hash
  models/weg.py           word-excitation guidance (loss, refinement)
  models/t5.py, audioenc.py, condfuser.py
                          condition encoders (T5 trunk x2, mel MLP, fuser);
                          models/text_cache.py: the trunk's host cache
  models/denoiser.py      7-branch guided denoiser
  models/vae.py           chunked body/hands VAE decoder
  diffusion/schedulers.py DDPM / DDIM / DPM-Solver++ 2M tables and steps
  ops/                    attention, transformer blocks, embeddings,
                          positional encodings, smoothing kernel, the
                          fused step kernel
  csrc/                   hand-written CUDA kernels (sm_90a)
  compat/from_jax.py      JAX parameter tree -> port state_dict
  data/                   BEAT/DnD datasets, collates, loader, fixture
                          trees, TextGrid, wav and mel (host and batch)
  native/                 the host C++ mel kernel (g++, ctypes)
  parallel/               data parallelism (mesh.py), tensor parallelism
                          (tp.py), the dp x tp dry run (dryrun.py)
  scripts/                host tools: BVH FK, BEAT joints, silence,
                          utterance sets, transcription, visualisation
  utils/                  quaternions, geometry, logger, SampleTimer
  data/synthetic.py       seeded synthetic batches (also long-form)

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
