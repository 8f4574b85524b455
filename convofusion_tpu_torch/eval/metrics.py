"""Quantitative gesture metrics.

A numpy and scipy copy of ``convofusion_tpu/eval/metrics.py:20-199``
(reference quant_eval/metric_eval.py: SRGR :317-339, L1div :342-356,
diversity :296-314, GAHR alignment :93-293, FID :21-90;
quant_eval/jitter_metric.py).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy import linalg
from scipy.signal import argrelextrema

from convofusion_tpu_torch.eval.onsets import audio_beats, frames_to_time
from convofusion_tpu_torch.utils.quaternion import qbetween_np, qrot_np


# --------------------------------------------------------------------- FID
def frechet_distance(samples_a: np.ndarray, samples_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    mu1, mu2 = samples_a.mean(0), samples_b.mean(0)
    s1 = np.cov(samples_a, rowvar=False)
    s2 = np.cov(samples_b, rowvar=False)
    diff = mu1 - mu2
    # (JAX passes disp=False, which SciPy 1.18 removed; the root is the
    # same either way)
    covmean = linalg.sqrtm(s1.dot(s2))
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset).dot(s2 + offset))
    if np.iscomplexobj(covmean):
        # ill-conditioned sqrtm (e.g. far fewer samples than feature
        # dims): the reference raises and its caller reports the 1e10
        # sentinel (dyadic_eval.py:29-31, 78-81) — silently taking the
        # real part would yield a bogus but plausible-looking FID
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            return 1e10
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


# --------------------------------------------------------------- alignment
class Alignment:
    """Audio-onset to gesture-beat alignment (GAHR)."""

    def __init__(self, sigma: float, order: int):
        self.sigma = sigma
        self.order = order

    def load_audio(self, y: np.ndarray, sr: int = 16000):
        return audio_beats(y, sr)

    def pose_beats(self, pose_flat: np.ndarray):
        """Wrist/arm/shoulder velocity local minima (metric_eval.py:124-165).
        pose_flat: (T, 189)."""
        vel = pose_flat[1:, :] - pose_flat[:-1, :]

        def vnorm(j):
            return np.linalg.norm(
                np.stack([vel[:, j * 3], vel[:, j * 3 + 1],
                          vel[:, j * 3 + 2]]), axis=0)

        beats = {}
        for name, j in (("right_shoulder", 9), ("right_arm", 10),
                        ("right_wrist", 11), ("left_shoulder", 5),
                        ("left_arm", 6), ("left_wrist", 7)):
            beats[name] = argrelextrema(vnorm(j), np.less,
                                        order=self.order)
        return beats

    @staticmethod
    def gahr(a: np.ndarray, b: np.ndarray, sigma: float) -> float:
        """mean over b of exp(-min_dist(a)^2 / 2 sigma^2)
        (metric_eval.py:263-274)."""
        total = 0.0
        for b_each in b:
            l2_min = np.inf
            for a_each in a:
                l2_min = min(l2_min, abs(a_each - b_each))
            total += math.exp(-(l2_min**2) / (2 * sigma**2))
        return total / len(b)

    def calculate_align(self, onset_bt_rms, pose_beats_dict,
                        pose_fps: int = 25) -> float:
        audio_bt = frames_to_time(onset_bt_rms)  # sr=22050 quirk preserved
        pose_bt = pose_beats_dict["right_wrist"][0] / pose_fps
        return self.gahr(pose_bt, audio_bt, self.sigma)

    def align_sample(self, audio: np.ndarray, pose_flat: np.ndarray,
                     sr: int = 16000, pose_fps: int = 25
                     ) -> Optional[float]:
        onset_raw, _, onset_bt_rms = self.load_audio(audio, sr)
        if onset_raw is None:
            return None
        return self.calculate_align(onset_bt_rms,
                                    self.pose_beats(pose_flat), pose_fps)


# ---------------------------------------------------------------- the rest
class SRGR:
    """Semantic-relevant gesture recall (semantic-weighted PCK)."""

    def __init__(self, threshold: float = 0.3, joints: int = 63):
        self.threshold = threshold
        self.joints = joints
        self.counter = 0
        self.sum = 0.0

    def run(self, results, targets, semantic) -> float:
        results = results.reshape(-1, self.joints, 3)
        targets = targets.reshape(-1, self.joints, 3)
        semantic = np.asarray(semantic).reshape(-1)
        diff = np.sum(np.abs(results - targets), 2)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success = success * semantic[:, None] * (1 / 0.165)
        rate = np.sum(success) / (success.shape[0] * success.shape[1])
        self.counter += success.shape[0]
        self.sum += rate * success.shape[0]
        return rate

    def avg(self):
        return self.sum / self.counter


class L1div:
    def __init__(self):
        self.counter = 0
        self.sum = 0.0

    def run(self, results):
        self.counter += results.shape[0]
        mean = np.mean(results, 0)
        self.sum += np.sum(np.abs(results - mean))

    def avg(self):
        return self.sum / self.counter


def calc_diversity(feats) -> float:
    feat_array = np.asarray(feats)
    n, c = feat_array.shape
    diff = np.array([feat_array] * n) - feat_array.reshape(n, 1, c)
    return float(np.sqrt(np.sum(diff**2, axis=2)).sum() / n / (n - 1))


def calculate_avg_distance(feature_list, mean=None, std=None) -> float:
    flat = [f.reshape(-1) for f in feature_list]
    if len({v.shape[0] for v in flat}) > 1:
        # mixed-length dumps (e.g. a truncated final rollout window):
        # pairwise L2 needs equal-length vectors — truncate to the
        # shortest rather than crashing mid-eval
        import warnings

        n_min = min(v.shape[0] for v in flat)
        warnings.warn(
            "diversity: clips have mixed lengths; truncating all to "
            f"{n_min} features for the pairwise distance")
        flat = [v[:n_min] for v in flat]
    feats = np.stack(flat)
    n = feats.shape[0]
    if mean is not None and std is not None:
        feats = (feats - mean) / std
    dist = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            dist += np.linalg.norm(feats[i] - feats[j])
    return dist / ((n * n - n) / 2)


def calculate_jitter(pred_motion, gt_motion) -> float:
    """(T, J, 3) each (jitter_metric.py:4-9)."""
    d_pred = np.abs(pred_motion[1:] - pred_motion[:-1])
    d_gt = np.abs(gt_motion[1:] - gt_motion[:-1])
    return float(np.mean(np.abs(d_pred - d_gt)))


def eval_process_motion(motion: np.ndarray) -> np.ndarray:
    """The eval-side canonicalization (metric_eval.py:376-422): same as the
    dataset one but WITHOUT the final x3 scaling/flatten."""
    motion = motion.copy()
    floor_height = motion.min(axis=0).min(axis=0)[1]
    motion[:, :, 1] -= floor_height
    root_pos_init = motion[0]
    motion = motion - root_pos_init[0] * np.array([1, 0, 1])
    r_hip, l_hip, sdr_r, sdr_l = 18, 13, 9, 5
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / np.sqrt((across**2).sum(axis=-1))[..., np.newaxis]
    forward_init = np.cross(np.array([[0, 1, 0]]), across, axis=-1)
    forward_init = forward_init / np.sqrt(
        (forward_init**2).sum(axis=-1))[..., np.newaxis]
    quat = qbetween_np(forward_init, np.array([[0, 0, 1]]))
    quat = np.ones(motion.shape[:-1] + (4,)) * quat
    motion = np.array(qrot_np(quat, motion))
    motion[:, 1:, :] = motion[:, 1:, :] - motion[:, :1, :]
    motion[:, 23:43, :] = motion[:, 23:43, :] - motion[:, [7], :]
    motion[:, 43:, :] = motion[:, 43:, :] - motion[:, [11], :]
    return motion
