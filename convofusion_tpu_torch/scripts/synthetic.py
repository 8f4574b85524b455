"""Seeded inputs for the host tools: a BEAT-skeleton BVH take and a
5-person session of speech bursts.

The real BEAT takes and DnD sessions are not in the repository.  These
files have their formats and sizes: a BVH tree with every joint
``beat_getjoints.JOINT_LIST`` needs (spine, neck and head, both arms with
five four-joint finger chains a hand, both legs, End Sites), one 120 fps
frame of channel values per line; and a session directory of
``person_<i>.wav`` (16 kHz tone bursts separated by silences) and
``person_<i>.npy`` (25 fps (T, 67, 3) motion), the layout
``make_utterance_dataset.process_session`` reads.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from convofusion_tpu_torch.data.audio import save_wav

_FINGERS = ("Thumb", "Index", "Middle", "Ring", "Pinky")


def _skeleton():
    """(name, parent index or None) in file order; an End Site is named
    ``<parent>End``."""
    joints: List = []

    def add(name, parent):
        joints.append((name, parent))
        return len(joints) - 1

    hips = add("Hips", None)
    spine = hips
    for name in ("Spine", "Spine1", "Spine2", "Spine3"):
        spine = add(name, spine)
    neck = add("Neck", spine)
    head = add("Head", add("Neck1", neck))
    add("HeadEnd", head)
    for side in ("Left", "Right"):
        hand = add(f"{side}Shoulder", spine)
        for name in ("Arm", "ForeArm", "Hand"):
            hand = add(f"{side}{name}", hand)
        for finger in _FINGERS:
            j = hand
            for k in range(1, 5):
                j = add(f"{side}Hand{finger}{k}", j)
            add(f"{side}Hand{finger}4End", j)
    for side in ("Left", "Right"):
        j = hips
        for name in ("UpLeg", "Leg", "Foot", "ToeBase"):
            j = add(f"{side}{name}", j)
        add(f"{side}ToeBaseEnd", j)
    return joints


def write_beat_bvh(path: str, n_frames: int, seed: int = 0,
                   frame_time: float = 0.008333, max_deg: float = 30.0):
    """A BEAT-skeleton BVH take at ``path``: seeded offsets, each joint's
    three rotation channels in a seeded order, rotations within
    +-``max_deg`` degrees and a wandering root translation."""
    rng = np.random.default_rng(seed)
    joints = _skeleton()
    children = {i: [c for c, (_, p) in enumerate(joints) if p == i]
                for i in range(len(joints))}
    lines, n_rot = ["HIERARCHY"], 0

    def emit(i, depth):
        nonlocal n_rot
        name, parent = joints[i]
        pad = "  " * depth
        offset = " ".join(f"{v:.4f}" for v in rng.uniform(-12, 12, 3))
        if name.endswith("End") and not children[i]:
            lines.extend([f"{pad}End Site", f"{pad}{{",
                          f"{pad}  OFFSET {offset}", f"{pad}}}"])
            return
        axes = " ".join(f"{a}rotation" for a in rng.permutation(list("ZXY")))
        head = "ROOT" if parent is None else "JOINT"
        chans = (f"CHANNELS 6 Xposition Yposition Zposition {axes}"
                 if parent is None else f"CHANNELS 3 {axes}")
        lines.extend([f"{pad}{head} {name}", f"{pad}{{",
                      f"{pad}  OFFSET {offset}", f"{pad}  {chans}"])
        n_rot += 3
        for c in children[i]:
            emit(c, depth + 1)
        lines.append(f"{pad}}}")

    emit(0, 0)
    root = np.cumsum(rng.normal(0, 0.5, (n_frames, 3)), axis=0)
    rot = rng.uniform(-max_deg, max_deg, (n_frames, n_rot))
    values = np.concatenate([root, rot], axis=1)
    lines += ["MOTION", f"Frames: {n_frames}", f"Frame Time: {frame_time}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        np.savetxt(f, values, fmt="%.6f")
    return path


def write_session(session_dir: str, seconds: float, seed: int = 0,
                  sr: int = 16000, fps: int = 25) -> str:
    """Five ``person_<i>.wav`` / ``person_<i>.npy`` tracks of ``seconds``:
    each person speaks seeded tone bursts of 1-12 s separated by 0.3-4 s
    of silence (a short gap inside a burst now and then), and moves as
    seeded (T, 67, 3) noise at ``fps``."""
    rng = np.random.default_rng(seed)
    os.makedirs(session_dir, exist_ok=True)
    n = int(seconds * sr)
    for p in range(5):
        y = np.zeros(n, np.float32)
        t = int(rng.uniform(0, 3) * sr)
        while t < n:
            length = int(rng.uniform(1, 12) * sr)
            tone = np.arange(min(length, n - t)) / sr
            burst = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 300) * tone)
            if rng.random() < 0.3:          # a short gap inside the burst
                g = int(rng.uniform(0.2, 0.8) * len(burst))
                burst[g:g + int(0.25 * sr)] = 0.0
            y[t:t + len(burst)] = burst
            t += length + int(rng.uniform(0.3, 4) * sr)
        save_wav(os.path.join(session_dir, f"person_{p}.wav"), y, sr)
        motion = rng.normal(size=(int(seconds * fps), 67, 3))
        np.save(os.path.join(session_dir, f"person_{p}.npy"),
                motion.astype(np.float32))
    return session_dir
