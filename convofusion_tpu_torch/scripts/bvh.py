"""BVH motion-capture parsing and world-position forward kinematics.

Port of ``convofusion_tpu/scripts/bvh.py``.  ``parse_bvh`` is host text
parsing (``:41-102``); its format checks raise ``ValueError``.  The forward
kinematics (``:105-161``) run in float64 torch on the device: every
rotation channel's (T, 3, 3) matrix is built in one batched call, then each
joint composes its channel rotations in file order and
``world = parent_world @ T(offset + position channels) @ R``, joint by
joint down the hierarchy (a parent precedes its children in the file).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from convofusion_tpu_torch import resolve_device


@dataclass
class BvhJoint:
    name: str
    parent: Optional[int]
    offset: np.ndarray
    channels: List[str] = field(default_factory=list)
    channel_start: int = 0


@dataclass
class BvhData:
    joints: List[BvhJoint]
    frames: np.ndarray          # (T, total_channels) float64
    frame_time: float

    @property
    def joint_names(self):
        return [j.name for j in self.joints]

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"malformed BVH: {what}")


def parse_bvh(path: str) -> BvhData:
    """The hierarchy (an End Site becomes joint ``<parent>End``) and the
    motion block of a BVH file."""
    with open(path) as f:
        tokens = f.read().split()
    pos = 0
    joints: List[BvhJoint] = []
    stack: List[int] = []
    channel_count = 0

    def expect(word):
        nonlocal pos
        _expect(pos < len(tokens) and tokens[pos].upper() == word,
                f"expected {word!r} at token {pos}")
        pos += 1

    expect("HIERARCHY")
    while pos < len(tokens) and tokens[pos].upper() != "MOTION":
        tok = tokens[pos].upper()
        if tok in ("ROOT", "JOINT"):
            name = tokens[pos + 1]
            pos += 2
            parent = stack[-1] if stack else None
            joints.append(BvhJoint(name, parent, np.zeros(3)))
            stack.append(len(joints) - 1)
            expect("{")
        elif tok == "END":  # End Site
            _expect(bool(stack), "an End Site outside a joint")
            name = joints[stack[-1]].name + "End"
            pos += 2  # 'End' 'Site'
            joints.append(BvhJoint(name, stack[-1], np.zeros(3)))
            stack.append(len(joints) - 1)
            expect("{")
        elif tok == "OFFSET":
            joints[stack[-1]].offset = np.array(
                [float(tokens[pos + 1]), float(tokens[pos + 2]),
                 float(tokens[pos + 3])])
            pos += 4
        elif tok == "CHANNELS":
            n = int(tokens[pos + 1])
            joints[stack[-1]].channels = tokens[pos + 2:pos + 2 + n]
            joints[stack[-1]].channel_start = channel_count
            channel_count += n
            pos += 2 + n
        elif tok == "}":
            stack.pop()
            pos += 1
        else:
            raise ValueError(f"unexpected BVH token {tokens[pos]}")

    expect("MOTION")
    _expect(tokens[pos].lower() == "frames:", "no 'Frames:'")
    n_frames = int(tokens[pos + 1])
    pos += 2
    # "Frame Time: <x>"
    _expect(tokens[pos].lower() == "frame" and
            tokens[pos + 1].lower() == "time:", "no 'Frame Time:'")
    frame_time = float(tokens[pos + 2])
    pos += 3
    values = np.asarray(tokens[pos:pos + n_frames * channel_count],
                        dtype=np.float64)
    frames = values.reshape(n_frames, channel_count)
    return BvhData(joints, frames, frame_time)


# axis letter -> (i, j): R[i, i] = R[j, j] = cos, R[i, j] = -sin,
# R[j, i] = sin, and 1 on the axis itself (``:105-122``)
_PLANES = {"X": (1, 2), "Y": (2, 0), "Z": (0, 1)}


def rotation_matrices(axes: Sequence[str], deg: torch.Tensor
                      ) -> torch.Tensor:
    """(..., K) degrees, column k about axis ``axes[k]`` ('X', 'Y' or
    'Z') -> (..., K, 3, 3) rotation matrices."""
    r = torch.deg2rad(deg)
    c, s = torch.cos(r), torch.sin(r)
    m = torch.zeros(*deg.shape, 3, 3, dtype=deg.dtype, device=deg.device)
    for axis, (i, j) in _PLANES.items():
        cols = [k for k, a in enumerate(axes) if a == axis]
        if not cols:
            continue
        k = 3 - i - j
        m[..., cols, i, i] = c[..., cols]
        m[..., cols, j, j] = c[..., cols]
        m[..., cols, i, j] = -s[..., cols]
        m[..., cols, j, i] = s[..., cols]
        m[..., cols, k, k] = 1.0
    bad = set(axes) - set(_PLANES)
    if bad:
        raise ValueError(f"rotation axes {sorted(bad)}")
    return m


def world_positions(data: BvhData, device=None
                    ) -> Tuple[torch.Tensor, List[str]]:
    """(T, J, 3) float64 world joint positions on ``device`` and the joint
    names.  Rotations compose in channel file order (the BVH convention);
    offsets and position channels included."""
    dev = resolve_device(device)
    frames = torch.from_numpy(np.ascontiguousarray(data.frames)).to(
        dev, torch.float64)
    t = frames.shape[0]
    # every rotation channel's matrices, in one batched build
    rot_cols, axes = [], []
    for joint in data.joints:
        for ci, ch in enumerate(joint.channels):
            if ch.lower().endswith("rotation"):
                rot_cols.append(joint.channel_start + ci)
                axes.append(ch[0].upper())
    rots = rotation_matrices(axes, frames[:, rot_cols])     # (T, K, 3, 3)
    eye = torch.eye(3, dtype=torch.float64, device=dev).expand(t, 3, 3)
    offsets = torch.from_numpy(np.stack(
        [np.asarray(j.offset, np.float64) for j in data.joints])).to(dev)

    world_rot: List[torch.Tensor] = []
    world_pos: List[torch.Tensor] = []
    k = 0
    for ji, joint in enumerate(data.joints):
        trans = offsets[ji].expand(t, 3).clone()
        local_rot = eye
        for ci, ch in enumerate(joint.channels):
            chl = ch.lower()
            col = frames[:, joint.channel_start + ci]
            if chl in ("xposition", "yposition", "zposition"):
                trans[:, "xyz".index(chl[0])] += col
            elif chl.endswith("rotation"):
                local_rot = local_rot @ rots[:, k]
                k += 1
            else:
                raise ValueError(f"BVH channel {ch}")
        if joint.parent is None:
            world_rot.append(local_rot)
            world_pos.append(trans)
        else:
            pr = world_rot[joint.parent]
            world_rot.append(pr @ local_rot)
            world_pos.append(world_pos[joint.parent]
                             + (pr @ trans[:, :, None])[:, :, 0])
    return torch.stack(world_pos, dim=1), data.joint_names


def positions_by_name(data: BvhData, device=None) -> Dict[str, torch.Tensor]:
    """Joint name -> its (T, 3) world positions; of joints that share a name
    (End sites), the first."""
    pos, names = world_positions(data, device)
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        out.setdefault(name, pos[:, i, :])
    return out
