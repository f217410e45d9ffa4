"""Linear blend skinning core (counterpart of
exavatar_release_tpu/models/smplx/lbs.py): blend shapes, FK, skinning,
landmarks, for one sample. FK unrolls in Python over the static parents
tuple.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def blend_shapes(coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """coeffs: (C,), dirs: (V, 3, C) -> (V, 3) displacement."""
    V = dirs.shape[0]
    return torch.matmul(dirs.reshape(V * 3, -1), coeffs).reshape(V, 3)


def vertices_to_joints(joint_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) @ (V, 3) -> (J, 3)."""
    return torch.matmul(joint_regressor, vertices)


def rigid_transform(
    rot_mats: torch.Tensor,
    joints: torch.Tensor,
    parents: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the joint tree.

    rot_mats: (J, 3, 3) local joint rotations; joints: (J, 3) rest positions;
    parents: static tuple, parents[0] == -1.

    Returns (posed_joints (J, 3), rel_transforms (J, 4, 4)): the skinning
    matrices A with the rest-pose joint location subtracted.
    """
    J = len(parents)
    parent_idx = torch.tensor(parents[1:], dtype=torch.long, device=joints.device)
    rel = torch.cat([joints[:1], joints[1:] - joints[parent_idx]], dim=0)
    top = torch.cat([rot_mats, rel[:, :, None]], dim=2)  # (J, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(J, 1, 4)
    local = torch.cat([top, bottom], dim=1)  # (J, 4, 4)

    chain = [local[0]]
    for i in range(1, J):
        chain.append(torch.matmul(chain[parents[i]], local[i]))
    transforms = torch.stack(chain, dim=0)  # (J, 4, 4)

    posed_joints = transforms[:, :3, 3]
    # A = T - [[0, T_rot @ j], [0, 0]]: subtract rest-pose joint location
    tj = torch.einsum("jab,jb->ja", transforms[:, :3, :3], joints)
    rel_transforms = transforms.clone()
    rel_transforms[:, :3, 3] = transforms[:, :3, 3] - tj
    return posed_joints, rel_transforms


def lbs(
    shape_coeffs: torch.Tensor,
    rot_mats: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    joint_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
    joint_offset: Optional[torch.Tensor] = None,
    locator_offset: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shape + pose-corrective + FK + skinning from (J, 3, 3) rotations.

    ``locator_offset`` shifts only the reported joints, never the skinning
    chain. Returns (vertices (V, 3), posed_joints (J, 3), A (J, 4, 4)).
    """
    v_shaped = v_template + blend_shapes(shape_coeffs, shapedirs)
    joints = vertices_to_joints(joint_regressor, v_shaped)
    if joint_offset is not None:
        joints = joints + joint_offset

    ident = torch.eye(3, dtype=v_template.dtype, device=v_template.device)
    pose_feature = (rot_mats[1:] - ident).reshape(-1)  # (9*(J-1),)
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(-1, 3)

    posed_joints, A = rigid_transform(rot_mats, joints, parents)
    if locator_offset is not None:
        posed_joints, _ = rigid_transform(rot_mats, joints + locator_offset, parents)
    return skin_vertices(v_posed, lbs_weights, A), posed_joints, A


def skin_vertices(
    v_posed: torch.Tensor, lbs_weights: torch.Tensor, A: torch.Tensor
) -> torch.Tensor:
    """v_posed: (V, 3); lbs_weights: (V, J); A: (J, 4, 4) -> (V, 3)."""
    J = A.shape[0]
    T = torch.matmul(lbs_weights, A[:, :3, :].reshape(J, 12)).reshape(-1, 3, 4)
    return torch.einsum("vij,vj->vi", T[:, :, :3], v_posed) + T[:, :, 3]


def vertices_to_landmarks(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    lmk_faces_idx: torch.Tensor,
    lmk_bary_coords: torch.Tensor,
) -> torch.Tensor:
    """Barycentric landmark interpolation: (L, 3)."""
    tri = vertices[faces[lmk_faces_idx.long()].long()]  # (L, 3, 3)
    return torch.einsum("lfi,lf->li", tri, lmk_bary_coords)


def neck_yaw_bucket(rot_mats: torch.Tensor, neck_kin_chain: Sequence[int]) -> torch.Tensor:
    """LUT row index in [0, 78] of the dynamic contour landmarks (clamp to
    39 degrees, negatives offset to 39-angle, < -39 saturates at row 78)."""
    rel = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    for idx in neck_kin_chain:
        rel = torch.matmul(rot_mats[idx], rel)
    sy = torch.sqrt(rel[0, 0] * rel[0, 0] + rel[1, 0] * rel[1, 0])
    yaw = torch.atan2(-rel[2, 0], sy)
    deg = torch.round(torch.clamp(-yaw * 180.0 / torch.pi, max=39.0))
    neg_vals = torch.where(deg < -39.0, 78.0, 39.0 - deg)
    return torch.where(deg < 0, neg_vals, deg).long()
