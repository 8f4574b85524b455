"""Rotation representations and forward kinematics, in torch.

Port of ``convofusion_tpu/utils/geometry.py:1-108`` (reference
convofusion/data/beat_dnd/utils/motion_rep_utils.py:241-315 and
convofusion/data/BEAT_DnD.py:39-60): euler (XYZ, degrees) <-> 6D <->
matrix, and forward kinematics over a kinematic tree, walking the chains
in a Python loop.
"""
from __future__ import annotations

import torch


def euler_to_matrix_xyz(euler_rad: torch.Tensor) -> torch.Tensor:
    """Euler angles (radians, XYZ) -> (*, 3, 3) = Rx @ Ry @ Rz (pytorch3d
    ``euler_angles_to_matrix(e, 'XYZ')``)."""
    x, y, z = euler_rad.unbind(-1)
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     dim=-1).reshape(x.shape + (3, 3))
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     dim=-1).reshape(y.shape + (3, 3))
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     dim=-1).reshape(z.shape + (3, 3))
    return rx @ ry @ rz


def matrix_to_euler_xyz(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) -> euler angles (radians, XYZ), pytorch3d's convention."""
    y = torch.asin(torch.clamp(matrix[..., 0, 2], -1.0, 1.0))
    x = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    z = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) -> (*, 6): the first two rows (Zhou et al. 2019)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(*, 6) -> (*, 3, 3) by Gram-Schmidt on the two encoded rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def euler_deg_to_6d(eulers: torch.Tensor, n_joints: int) -> torch.Tensor:
    """(frames, J*3) degrees -> (frames, J*6)."""
    e = torch.deg2rad(eulers.reshape(-1, n_joints, 3))
    return matrix_to_rotation_6d(euler_to_matrix_xyz(e)).reshape(
        -1, n_joints * 6)


def rep6d_to_euler_deg(rep6d: torch.Tensor, n_joints: int) -> torch.Tensor:
    """(frames, J*6) -> (frames, J*3) degrees."""
    m = rotation_6d_to_matrix(rep6d.reshape(-1, n_joints, 6))
    return torch.rad2deg(matrix_to_euler_xyz(m)).reshape(-1, n_joints * 3)


def _fk(local_rots, root_pos, offsets, kinematic_tree, do_root_R=True,
        compose_left=False):
    """The FK walk. local_rots (B, J, 3, 3); offsets (J, 3)."""
    b = local_rots.shape[0]
    offsets = torch.as_tensor(offsets, dtype=local_rots.dtype,
                              device=local_rots.device)
    joints = [None] * local_rots.shape[1]
    joints[0] = root_pos
    eye = torch.eye(3, dtype=local_rots.dtype,
                    device=local_rots.device).expand(b, 3, 3)
    for chain in kinematic_tree:
        # every chain starts from the root rotation (motion_rep_utils.py:
        # 286-288, :306-308)
        mat_r = local_rots[:, 0] if do_root_R else eye
        for i in range(1, len(chain)):
            if compose_left:
                # cont6d: child @ accumulated (motion_rep_utils.py:278-295)
                mat_r = local_rots[:, chain[i]] @ mat_r
            else:
                # euler: accumulated @ child (motion_rep_utils.py:300-315)
                mat_r = mat_r @ local_rots[:, chain[i]]
            off = offsets[None, chain[i], :, None]
            joints[chain[i]] = (mat_r @ off)[..., 0] + joints[chain[i - 1]]
    return torch.stack(joints, dim=1)


def forward_kinematics_euler(eulers_rad, root_pos, offsets, kinematic_tree,
                             do_root_R=True):
    """eulers_rad (B, J, 3) radians; root_pos (B, 3); offsets (J, 3)."""
    return _fk(euler_to_matrix_xyz(eulers_rad), root_pos, offsets,
               kinematic_tree, do_root_R, compose_left=False)


def forward_kinematics_cont6d(cont6d, root_pos, offsets, kinematic_tree,
                              do_root_R=True):
    """cont6d (B, J, 6); root_pos (B, 3); offsets (J, 3)."""
    return _fk(rotation_6d_to_matrix(cont6d), root_pos, offsets,
               kinematic_tree, do_root_R, compose_left=True)
