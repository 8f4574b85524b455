"""BEAT BVH -> joint-position .npy conversion.

Port of ``convofusion_tpu/scripts/beat_getjoints.py``: the reference's
79-entry joint list (PyMO's position parameterization, with synthesized
Left/RightHandMid joints averaged over the five finger bases) over the
port's BVH parser and forward kinematics (``scripts/bvh.py``, float64 on
the device).  A file that does not parse is reported and skipped, as the
reference skips corrupt takes.

Run: python -m convofusion_tpu_torch.scripts.beat_getjoints
     --beat_path <dir> [--out_path <dir>] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from convofusion_tpu_torch.scripts.bvh import parse_bvh, positions_by_name

# same selection/order as the reference's joint_list
# (scripts/beat_getjoints.py:10-80)
JOINT_LIST = [
    "HeadEnd", "Neck1", "LeftShoulder", "Spine", "Spine1", "LeftArm",
    "LeftForeArm", "LeftHand", "LeftHandMid", "RightArm", "RightForeArm",
    "RightHand", "RightHandMid", "LeftUpLeg", "LeftLeg", "LeftFoot",
    "LeftToeBase", "LeftToeBaseEnd", "RightUpLeg", "RightLeg",
    "RightFoot", "RightToeBase", "RightToeBaseEnd",
    # left hand block
    "LeftHand", "LeftHandThumb1", "LeftHandThumb2", "LeftHandThumb3",
    "LeftHandThumb4", "LeftHandIndex1", "LeftHandIndex2",
    "LeftHandIndex3", "LeftHandIndex4", "LeftHandMiddle1",
    "LeftHandMiddle2", "LeftHandMiddle3", "LeftHandMiddle4",
    "LeftHandRing1", "LeftHandRing2", "LeftHandRing3", "LeftHandRing4",
    "LeftHandPinky1", "LeftHandPinky2", "LeftHandPinky3",
    "LeftHandPinky4", "LeftHandMid",
    # right hand block
    "RightHand", "RightHandThumb1", "RightHandThumb2",
    "RightHandThumb3", "RightHandThumb4", "RightHandIndex1",
    "RightHandIndex2", "RightHandIndex3", "RightHandIndex4",
    "RightHandMiddle1", "RightHandMiddle2", "RightHandMiddle3",
    "RightHandMiddle4", "RightHandRing1", "RightHandRing2",
    "RightHandRing3", "RightHandRing4", "RightHandPinky1",
    "RightHandPinky2", "RightHandPinky3", "RightHandPinky4",
    "RightHandMid",
]

_MID_BASES = {
    "LeftHandMid": ["LeftHand", "LeftHandIndex1", "LeftHandRing1",
                    "LeftHandPinky1", "LeftHandThumb1"],
    "RightHandMid": ["RightHand", "RightHandIndex1", "RightHandRing1",
                     "RightHandPinky1", "RightHandThumb1"],
}


def bvh_to_joint_positions(path: str, device=None) -> np.ndarray:
    """(T-1, len(JOINT_LIST), 3) float32 positions (the reference drops the
    last frame, beat_getjoints.py:116); the kinematics in float64 on
    ``device``."""
    by_name = positions_by_name(parse_bvh(path), device)
    cols = [torch.stack([by_name[b] for b in _MID_BASES[joint]]).mean(0)
            if joint in _MID_BASES else by_name[joint]
            for joint in JOINT_LIST]
    out = torch.stack(cols, dim=1)[:-1].to(torch.float32)
    return out.cpu().numpy()


def convert_speaker(speaker_dir: str, out_dir: str, device=None) -> int:
    """Every ``*.bvh`` of ``speaker_dir`` without a ``.npy`` in ``out_dir``
    yet; returns the number converted.  A file that does not parse or
    lacks a joint is reported and skipped."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for bvh_path in sorted(glob.glob(os.path.join(speaker_dir, "*.bvh"))):
        out_path = os.path.join(
            out_dir, os.path.basename(bvh_path)[:-3] + "npy")
        if os.path.exists(out_path):
            continue
        try:
            joints = bvh_to_joint_positions(bvh_path, device)
        except (ValueError, KeyError, IndexError, OSError) as e:
            print(f"Error in file: {bvh_path} {e!r}")
            continue
        np.save(out_path, joints)
        count += 1
    return count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--beat_path", required=True)
    ap.add_argument("--out_path", default=None)
    ap.add_argument("--speakers", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the card")
    args = ap.parse_args(argv)
    out_root = args.out_path or args.beat_path
    for s in range(1, args.speakers + 1):
        spk_dir = os.path.join(args.beat_path, str(s))
        if os.path.isdir(spk_dir):
            n = convert_speaker(spk_dir, os.path.join(out_root, str(s)),
                                args.device)
            print(f"speaker {s}: converted {n} files")


if __name__ == "__main__":
    main()
