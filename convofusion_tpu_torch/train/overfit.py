"""The learning proof: overfit both stages on the on-disk fixture.

Port of ``convofusion_tpu/train/overfit.py:1-422``.  The parity tests hold
one to three steps against JAX; this module shows that the port *learns*:
its trained model's samples reproduce the data it was trained on.

Protocol, through the port's own entry points:
  1. stage-1 ``cli/train`` on the lowrank BEAT + DnD fixture until the VAE
     reconstructs its training clips (relative RMSE near zero);
  2. stage-2 ``cli/train`` over the stage-1 VAE until the denoiser's
     conditioned DDIM-50 samples reproduce the paired training motions
     (per-sample RMSE and nearest-neighbour retrieval over the train set);
  3. a ``cli/test`` dump with production guidance -> ``eval/run`` metrics
     on the trained weights, against the same dump from the untrained
     initialization.

Run:  python -m convofusion_tpu_torch.train.overfit --workdir <dir> \\
          [--scale small|prod] [--device cpu] [--assert-thresholds]

The configs compute in fp32 (``TPU.COMPUTE_DTYPE: float32``), the dtype the
JAX package's CLIs and its proof compute in.  The result is written to
``<workdir>/overfit_result.json``:
every key of JAX's ``docs/artifacts/overfit_result.json`` plus the card's
name and power limit and each stage's wall seconds.
"""
from __future__ import annotations

import copy
import glob
import json
import os
import subprocess
import time

import numpy as np
import yaml


# ----------------------------------------------------------------- fixtures
def build_fixture(root: str):
    """BEAT (2 speakers x 11 s -> 4 chunked clips) + DnD (2 utterance sets
    -> 4 active-listener samples, 10 VAE person-clips), lowrank motion: each
    clip is a 16-coefficient mix of shared smooth modes, so a chunk's
    information fits the VAE's two tokens and "recon near zero" is reachable
    by construction (JAX :36-61)."""
    from convofusion_tpu_torch.data.fixture import (
        make_beat_fixture,
        make_dnd_fixture,
    )

    beat = os.path.join(root, "beat")
    dnd = os.path.join(root, "dnd")
    os.makedirs(beat, exist_ok=True)
    os.makedirs(dnd, exist_ok=True)
    make_beat_fixture(beat, speakers=("2_scott", "4_lawrence"),
                      seconds=11.0, motion_mode="lowrank")
    make_dnd_fixture(dnd, n_sets=2, motion_mode="lowrank")
    return beat, dnd


# ------------------------------------------------------------------ configs
# TPU.COMPUTE_DTYPE of every config written (base.yaml's is bf16)
COMPUTE_DTYPE = "float32"

SCALES = {
    # the production topology at small widths
    "small": {
        "latent_dim": [1, 32],
        "motion_vae": {"params": {
            "num_layers": 3, "ff_size": 64, "dropout": 0.0}},
        "denoiser": {"params": {
            "num_layers": 3, "ff_size": 64, "dropout": 0.0,
            "text_encoded_dim": 64, "audio_encoded_dim": 64}},
        "text_encoder": {"params": {
            "latent_dim": 64, "d_model": 32, "d_ff": 64,
            "num_layers": 2, "num_heads": 4, "d_kv": 8,
            "vocab_size": 1000}},
        "audio_encoder": {"params": {"latent_dim": 64}},
    },
    # the shipped production geometry untouched
    "prod": {},
}


def _merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            _merge(a[k], v)
        else:
            a[k] = v


def write_cfg(root, beat, dnd, name, *, stage, epochs, batch, lr,
              scale="small", extra=None, infer_steps=50, seed=1234):
    """Experiment and assets yamls over the packaged defaults (JAX
    :91-162).  The module yamls merge after the experiment yaml, so every
    model override (the SCALES geometry, the DDIM scheduler with
    ``clip_sample: false``, ``extra['model']``) rides the assets file, which
    merges last; in the experiment file the packaged module defaults would
    clobber it (docs/BENCHMARKS.md "Learning loop").  ``clip_sample`` is
    off because the overfit VAE trains at LAMBDA_KL 1e-5: its latents are
    not bound to the prior's [-1, 1], and clipping x0 there keeps samples
    from any clip's mode."""
    from convofusion_tpu_torch.config import DEFAULTS_DIR

    cfg = {
        "NAME": name,
        "DEBUG": False,
        "SEED_VALUE": seed,
        "FOLDER": os.path.join(root, "experiments"),
        "TRAIN": {
            "STAGE": stage,
            "BATCH_SIZE": batch,
            "END_EPOCH": epochs,
            "OPTIM": {"TYPE": "AdamW", "LR": lr},
        },
        "TEST": {"BATCH_SIZE": batch, "SAVE_PREDICTIONS": True,
                 "FOLDER": os.path.join(root, "results")},
        "LOGGER": {
            # checkpoint only at the end; no mid-run validation
            "SACE_CHECKPOINT_EPOCH": max(epochs, 1),
            "VAL_EVERY_STEPS": 0,
        },
        "TPU": {"COMPUTE_DTYPE": COMPUTE_DTYPE},
    }
    if scale == "small":
        cfg["TPU"]["TEXT_PAD_LEN"] = 16
    if extra:
        _merge(cfg, extra)
    path = os.path.join(root, f"cfg_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assets_path = os.path.join(root, f"assets_{name}.yaml")
    with open(os.path.join(DEFAULTS_DIR, "assets.yaml")) as f:
        assets = yaml.safe_load(f)
    assets["DATASET"]["BEATDND"]["ROOT"] = [beat, dnd]
    assets["DATASET"]["BEATDND"]["SPLIT_ROOT"] = [beat, dnd]
    assets["FOLDER"] = os.path.join(root, "experiments")
    assets["TEST"] = {"FOLDER": os.path.join(root, "results")}
    # a copy: merging ``extra['model']`` below must not reach SCALES
    _merge(assets.setdefault("model", {}), copy.deepcopy(SCALES[scale]))
    assets["model"]["scheduler"] = {
        "variant": "ddim", "num_inference_timesteps": infer_steps,
        "params": {"clip_sample": False}}
    if extra and "model" in extra:
        _merge(assets["model"], extra["model"])
    with open(assets_path, "w") as f:
        yaml.safe_dump(assets, f)
    return path, assets_path


def _ckpt_path(root, name, epochs):
    """The last epoch's file of the experiment (the CLI writes
    ``epoch=<n>.ckpt``)."""
    return os.path.join(root, "experiments", "convofusion", name,
                        "checkpoints", f"epoch={epochs - 1}.ckpt")


def _final_metrics(root, name):
    """Last line of the experiment's metrics JSONL."""
    last = {}
    for p in glob.glob(os.path.join(
            root, "experiments", "convofusion", name, "*.jsonl")):
        with open(p) as f:
            for line in f:
                last = json.loads(line)
    return last


# -------------------------------------------------------------- measurement
def vae_recon_error(cfg_path, assets_path, ckpt, device=None):
    """Deterministic encode -> decode relative RMSE over the train clips
    (JAX :185-220), divided by the per-feature-centred std: the rest pose
    shared by every clip leaves the denominator, so a model that memorizes
    the mean pose scores near 1."""
    import torch

    from convofusion_tpu_torch.cli.test import compute_dtype
    from convofusion_tpu_torch.config import from_cfg, parse_args
    from convofusion_tpu_torch.data.datamodule import get_datasets
    from convofusion_tpu_torch.models.convofusion import Convofusion
    from convofusion_tpu_torch.train.checkpoint import load_checkpoint

    cfg = parse_args("test", ["--cfg", cfg_path,
                              "--cfg_assets", assets_path])
    datamodule = get_datasets(cfg)[0]
    model = Convofusion(from_cfg(cfg, stage="vae"), dtype=compute_dtype(cfg),
                        device=device, seed=None, stage="vae")
    load_checkpoint(ckpt, model)

    recs, gts = [], []
    with torch.no_grad():
        for batch in datamodule.train_dataloader(seed=0):
            motion = torch.from_numpy(np.asarray(batch["motion"])).to(
                model.device)
            latent, _, _ = model.vae.encode(motion)
            rec = model.vae.decode(latent, motion.shape[1])
            recs.append(rec.double().cpu().numpy())
            gts.append(np.asarray(batch["motion"], np.float64))
    r = np.concatenate(recs)
    m = np.concatenate(gts)
    sig = m - m.reshape(-1, m.shape[-1]).mean(0)
    return float(np.sqrt(((r - m) ** 2).mean())
                 / np.sqrt((sig ** 2).mean()))


def reproduction_metrics(dump_dir):
    """Conditioned samples against their paired training motions (JAX
    :223-253):

    * rel_rmse: mean per-sample RMSE(pred, own gt) / the gts' std
    * retrieval_top1: the share of samples whose nearest gt (L2 over the
      whole clip) is their own
    * margin: mean RMSE against the other gts / mean RMSE against the own
    """
    dirs = sorted(d for d, _, files in os.walk(dump_dir)
                  if "pred.npy" in files)
    preds = np.stack([np.load(os.path.join(d, "pred.npy")) for d in dirs])
    gts = np.stack([np.load(os.path.join(d, "gt.npy")) for d in dirs])
    n = len(dirs)
    flat_p = preds.reshape(n, -1).astype(np.float64)
    flat_g = gts.reshape(n, -1).astype(np.float64)
    d2 = ((flat_p[:, None] - flat_g[None]) ** 2).mean(-1)
    rmse = np.sqrt(d2)
    own = np.diag(rmse)
    other = (rmse.sum(1) - own) / (n - 1)
    std = flat_g.std()
    return {
        "n_samples": n,
        "rel_rmse": float(own.mean() / std),
        "retrieval_top1": float((rmse.argmin(1) == np.arange(n)).mean()),
        "margin": float(other.mean() / own.mean()),
    }


# the pass criteria at the default budgets (JAX :256-264); the live run and
# the committed artifact are held to this one dict.  A conditioning-blind
# denoiser scores top1 ~0.125 (chance) and margin ~1.0.
DEFAULT_THRESHOLDS = {
    "vae_recon_rel_rmse": 0.15,    # upper
    "repro_retrieval_top1": 0.99,  # lower: every sample retrieves its pair
    "repro_margin": 3.0,           # lower: vs-others / vs-own RMSE
}


def card_line(device=None) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    import torch

    from convofusion_tpu_torch import resolve_device

    if resolve_device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[torch.cuda.current_device()]


# --------------------------------------------------------------- the proof
def run(workdir, *, scale="small", vae_epochs=2000, diff_epochs=10000,
        vae_batch=7, diff_batch=8, vae_lr=1e-3, diff_lr=1e-3,
        infer_steps=50, eval_untrained=True, log=print, thresholds=None,
        device=None):
    """The two-stage proof (JAX :268-382).  ``thresholds`` (optional) is a
    dict of pass criteria, upper bounds for ``*rmse`` / ``*loss`` keys and
    lower bounds otherwise, checked at the end: an AssertionError lists
    every failure.  The result is always written to
    ``<workdir>/overfit_result.json``."""
    from convofusion_tpu_torch.cli.test import main as test_main
    from convofusion_tpu_torch.cli.train import main as train_main
    from convofusion_tpu_torch.eval.run import evaluate_results

    dev_args = [] if device is None else ["--device", str(device)]
    os.makedirs(workdir, exist_ok=True)
    beat, dnd = build_fixture(workdir)
    out = {"scale": scale, "vae_epochs": vae_epochs,
           "diff_epochs": diff_epochs}
    seconds = {}

    def cfgs(name, **kw):
        return write_cfg(workdir, beat, dnd, name, scale=scale,
                         infer_steps=infer_steps, **kw)

    def timed(what, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[what] = time.perf_counter() - t0
        return res

    # ---- stage 1: the VAE ----
    cfg1, assets1 = cfgs("overfit_vae", stage="vae", epochs=vae_epochs,
                         batch=vae_batch, lr=vae_lr)
    log(f"stage 1: training VAE for {vae_epochs} epochs")
    timed("vae_train", train_main,
          ["--cfg", cfg1, "--cfg_assets", assets1] + dev_args)
    vae_ckpt = _ckpt_path(workdir, "overfit_vae", vae_epochs)
    assert os.path.isfile(vae_ckpt), vae_ckpt
    out["vae_final_loss"] = _final_metrics(workdir, "overfit_vae").get(
        "total/train")
    out["vae_recon_rel_rmse"] = vae_recon_error(cfg1, assets1, vae_ckpt,
                                                device)
    log(f"stage 1 done: recon rel RMSE {out['vae_recon_rel_rmse']:.4f}")

    # ---- stage 2: diffusion over the frozen VAE ----
    cfg2, assets2 = cfgs("overfit_diff", stage="diffusion",
                         epochs=diff_epochs, batch=diff_batch, lr=diff_lr,
                         extra={"TRAIN": {"PRETRAINED_VAE": vae_ckpt}})
    log(f"stage 2: training denoiser for {diff_epochs} epochs")
    timed("diff_train", train_main,
          ["--cfg", cfg2, "--cfg_assets", assets2] + dev_args)
    diff_ckpt = _ckpt_path(workdir, "overfit_diff", diff_epochs)
    assert os.path.isfile(diff_ckpt), diff_ckpt
    out["diff_final_loss"] = _final_metrics(workdir, "overfit_diff").get(
        "total/train")
    out["diff_ckpt"] = diff_ckpt
    out["diff_cfg"] = cfg2
    out["diff_assets"] = assets2

    # ---- conditioned reproduction: guidance off, the conditional
    # distribution itself ----
    cfgr, assetsr = cfgs("overfit_repro", stage="diffusion", epochs=1,
                         batch=diff_batch, lr=diff_lr,
                         extra={"TEST": {"CHECKPOINTS": diff_ckpt},
                                "model": {"guidance_scale": 1.0}})
    repro = timed("repro_dump", test_main,
                  ["--cfg", cfgr, "--cfg_assets", assetsr] + dev_args)
    out["repro"] = reproduction_metrics(repro.out_dir)
    log(f"reproduction: {out['repro']}")

    # ---- production-mode dump (7-way guidance) -> offline eval ----
    cfgg, assetsg = cfgs("overfit_gen", stage="diffusion", epochs=1,
                         batch=diff_batch, lr=diff_lr,
                         extra={"TEST": {"CHECKPOINTS": diff_ckpt}})
    gen = timed("gen_dump", test_main,
                ["--cfg", cfgg, "--cfg_assets", assetsg] + dev_args)
    out["eval_trained"] = _run_eval(gen.out_dir, evaluate_results, device)
    log(f"eval (trained): {out['eval_trained']}")

    if eval_untrained:
        # the same pipeline from the untrained init: the gap in metric
        # space is the learning signal
        cfgu, assetsu = cfgs("overfit_untrained", stage="diffusion",
                             epochs=1, batch=diff_batch, lr=diff_lr)
        unt = timed("untrained_dump", test_main,
                    ["--cfg", cfgu, "--cfg_assets", assetsu] + dev_args)
        out["eval_untrained"] = _run_eval(unt.out_dir, evaluate_results,
                                          device)
        out["repro_untrained"] = reproduction_metrics(unt.out_dir)
        log(f"eval (untrained): {out['eval_untrained']}")

    out["card"] = card_line(device)
    out["compute_dtype"] = COMPUTE_DTYPE
    out["stage_seconds"] = seconds
    with open(os.path.join(workdir, "overfit_result.json"), "w") as f:
        json.dump(out, f, indent=2)
    if thresholds:
        _check_thresholds(out, thresholds)
    return out


def _check_thresholds(out, thresholds):
    """Upper bounds for *rmse / *loss keys, lower bounds otherwise."""
    flat = dict(out)
    for k, v in (out.get("repro") or {}).items():
        flat[f"repro_{k}"] = v
    failures = []
    for key, bound in thresholds.items():
        val = flat.get(key)
        upper = ("rmse" in key) or ("loss" in key)
        if val is None:
            failures.append(f"{key}: missing from results")
        elif upper and not val <= bound:
            failures.append(f"{key}: {val:.4f} > {bound} (upper bound)")
        elif not upper and not val >= bound:
            failures.append(f"{key}: {val:.4f} < {bound} (lower bound)")
    assert not failures, "overfit thresholds failed: " + "; ".join(failures)


def _run_eval(result_dir, evaluate_results, device=None):
    import warnings

    with warnings.catch_warnings():
        # random-init FID features warn by design (no released net)
        warnings.simplefilter("ignore")
        metrics = evaluate_results(result_dir, "dyadic", fidnet_path=None,
                                   device=device)
    return {k: (round(float(v), 5)
                if isinstance(v, (int, float, np.floating, np.integer))
                else v)
            for k, v in metrics.items()}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--scale", default="small", choices=sorted(SCALES))
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the card)")
    ap.add_argument("--vae-epochs", type=int, default=2000)
    ap.add_argument("--diff-epochs", type=int, default=10000)
    ap.add_argument("--vae-lr", type=float, default=1e-3)
    ap.add_argument("--diff-lr", type=float, default=1e-3)
    ap.add_argument("--infer-steps", type=int, default=50)
    ap.add_argument("--assert-thresholds", action="store_true",
                    help="fail (nonzero exit) unless the run clears "
                         "DEFAULT_THRESHOLDS")
    args = ap.parse_args(argv)
    out = run(args.workdir, scale=args.scale, vae_epochs=args.vae_epochs,
              diff_epochs=args.diff_epochs, vae_lr=args.vae_lr,
              diff_lr=args.diff_lr, infer_steps=args.infer_steps,
              thresholds=DEFAULT_THRESHOLDS if args.assert_thresholds
              else None, device=args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
