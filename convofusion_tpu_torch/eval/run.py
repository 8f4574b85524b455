"""Offline evaluation over saved result directories.

Port of ``convofusion_tpu/eval/run.py:36-190`` (reference
quant_eval/metric_eval.py: monadic/BEAT, SRGR + L1div + alignment +
diversity; quant_eval/dyadic_eval.py: DnD, FID + alignment + diversity +
L1div), walking every ``gt.npy`` under the result directory that
``cli/test.py`` or ``cli/unbounded.py`` wrote.  The metrics are host numpy
(``eval/metrics.py``); the FID feature net runs in fp32 on the card unless
``device`` names another, with TF32 off so its features are the CPU's.

    python -m convofusion_tpu_torch.eval.run --result_dir <dir> \\
        --mode monadic|dyadic [--fidnet <last_499.bin>] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import warnings

import numpy as np
import torch

from convofusion_tpu_torch import resolve_device
from convofusion_tpu_torch.data.audio import load_wav, normalize
from convofusion_tpu_torch.eval.fid_net import (
    HalfEmbeddingNet,
    load_torch_fidnet,
)
from convofusion_tpu_torch.eval.metrics import (
    Alignment,
    L1div,
    SRGR,
    calculate_avg_distance,
    calculate_jitter,
    eval_process_motion,
    frechet_distance,
)

FID_POSE_LENGTH = 128  # HalfEmbeddingNet's lin0 is hard-wired to 128 frames


def fid_features(net: HalfEmbeddingNet, poses: np.ndarray) -> np.ndarray:
    """(N, 128, 189) -> (N, 300) in fp32 on the net's device, TF32 off."""
    dev = next(net.parameters()).device
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = net(torch.from_numpy(poses).to(dev, torch.float32))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return out.cpu().numpy()


def evaluate_results(result_dir: str, mode: str = "monadic",
                     fidnet_path: str | None = None,
                     max_samples: int | None = None, device=None) -> dict:
    dev = resolve_device(device)
    if mode == "monadic":
        alignmenter = Alignment(sigma=0.3, order=10)
    else:
        alignmenter = Alignment(sigma=1.25, order=12)
    srgr_cal = SRGR(0.3, 63)
    l1_calculator = L1div()

    # sample names contain slashes (e.g. dnd/session/set_l1), so recurse
    # rather than the reference's fixed */*/gt.npy depth
    gt_files = sorted(glob.glob(
        os.path.join(result_dir, "**", "gt.npy"), recursive=True))
    if max_samples:
        gt_files = gt_files[:max_samples]
    if not gt_files:
        raise FileNotFoundError(f"no gt.npy under {result_dir}")

    fid_net = None
    fid_random_init = False
    if not (fidnet_path and os.path.exists(fidnet_path)):
        # asset-drop contract (utils/assets.py): the released FID net
        # activates when present
        from convofusion_tpu_torch.utils.assets import asset_path

        dropped = asset_path("eval/last_499.bin")
        if dropped:
            fidnet_path = dropped
    if fidnet_path and os.path.exists(fidnet_path):
        fid_net = HalfEmbeddingNet(FID_POSE_LENGTH, 189, 300)
        fid_net.load_state_dict(load_torch_fidnet(fidnet_path))
    elif mode == "dyadic":
        # FID features need the released autoencoder
        # (quant_eval/dyadic_eval.py:31-34).  Random-init features give a
        # number but not a comparable metric: it is reported under its own
        # name so a smoke run cannot pass for an evaluation
        warnings.warn(
            f"FID net weights not found at {fidnet_path!r}; computing FID "
            "with a RANDOM-INIT feature extractor. The value is reported "
            "as 'fid_random_init_features' and is NOT comparable to the "
            "published metric.")
        fid_net = HalfEmbeddingNet(FID_POSE_LENGTH, 189, 300)
        fid_net.load_state_dict(fid_net.init_params(0))
        fid_random_init = True

    align, counter = 0.0, 0
    jitters = []
    pred_all, tar_all = [], []
    missing_sem = 0
    fid_skipped = 0

    for gt_file in gt_files:
        gt = np.load(gt_file)
        pred = np.load(gt_file.replace("gt.npy", "pred.npy"))
        t = gt.shape[0]
        gt_flat = gt.reshape(t, -1)
        pred_flat = pred.reshape(t, -1)

        if mode == "monadic":
            sem_file = gt_file.replace("gt.npy", "sem_lsn.npy")
            if os.path.exists(sem_file):
                sem = np.load(sem_file)
            else:
                sem = np.zeros(t)
                missing_sem += 1
            srgr_cal.run(pred_flat.copy(), gt_flat.copy(), sem)
            l1_calculator.run(pred_flat.copy())
        else:
            l1_calculator.run(gt_flat.copy())

        jitters.append(calculate_jitter(pred, gt))

        gt_np = eval_process_motion(gt.reshape(t, 63, 3))
        pred_np = eval_process_motion(pred.reshape(t, 63, 3))
        pred_all.append(pred_np)
        tar_all.append(gt_np)

        audio_file = gt_file.replace("gt.npy", "lsn_audio.wav")
        if os.path.exists(audio_file):
            audio, _ = load_wav(audio_file, 16000)
            audio = normalize(audio)
            a = alignmenter.align_sample(audio, pred_flat)
            if a is not None:
                align += a
                counter += 1

    lat_pred = lat_gt = None
    if fid_net is not None:
        # one batched forward per side; the feature net is hard-wired to
        # 128-frame clips (motion_autoencoder.py lin0 = 59*base), so clips
        # of any other length are skipped, with a count
        keep = [i for i, p in enumerate(pred_all)
                if p.shape[0] == FID_POSE_LENGTH]
        fid_skipped = len(pred_all) - len(keep)
        if fid_skipped:
            warnings.warn(
                f"FID: skipping {fid_skipped} clip(s) whose length != "
                f"{FID_POSE_LENGTH} frames (feature net is fixed-length)")
        if len(keep) > 1:
            fid_net.to(dev)
            pred_b = np.stack([pred_all[i].reshape(FID_POSE_LENGTH, 189)
                               for i in keep]).astype(np.float32)
            gt_b = np.stack([tar_all[i].reshape(FID_POSE_LENGTH, 189)
                             for i in keep]).astype(np.float32)
            lat_pred = fid_features(fid_net, pred_b)
            lat_gt = fid_features(fid_net, gt_b)

    out = {
        "n_samples": len(gt_files),
        "alignment": align / counter if counter else None,
        "diversity_pred": calculate_avg_distance(pred_all),
        "diversity_gt": calculate_avg_distance(tar_all),
        "l1div": l1_calculator.avg(),
        "jitter": float(np.mean(jitters)),
    }
    if mode == "monadic":
        if missing_sem:
            # zero semantic weights force SRGR to exactly 0: flagged so a
            # dump without annotations is not taken for a score
            warnings.warn(
                f"{missing_sem}/{len(gt_files)} samples had no "
                "sem_lsn.npy (zero semantic weights); SRGR is reported "
                "as 'srgr_missing_sem' and is not comparable.")
            out["srgr_missing_sem"] = srgr_cal.avg()
        else:
            out["srgr"] = srgr_cal.avg()
    if lat_pred is not None:
        key = "fid_random_init_features" if fid_random_init else "fid"
        out[key] = frechet_distance(lat_pred, lat_gt)
        if fid_skipped:
            out["fid_skipped_clips"] = fid_skipped
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--result_dir", required=True)
    ap.add_argument("--mode", default="monadic",
                    choices=["monadic", "dyadic"])
    ap.add_argument("--fidnet", default="./experiments/eval/last_499.bin")
    ap.add_argument("--max_samples", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the card)")
    args = ap.parse_args(argv)
    out = evaluate_results(args.result_dir, args.mode, args.fidnet,
                           args.max_samples, device=args.device)
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
