"""SMPL-X forward pass (counterpart of
exavatar_release_tpu/models/smplx/model.py:smplx_forward)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.rotations import axis_angle_to_matrix
from .lbs import (
    blend_shapes,
    lbs,
    neck_yaw_bucket,
    vertices_to_joints,
    vertices_to_landmarks,
)
from .structs import SMPLXAssets, SMPLXOutput, SMPLXParams


def smplx_forward(
    assets: SMPLXAssets,
    params: SMPLXParams,
    face_offset: Optional[torch.Tensor] = None,  # (V, 3)
    joint_offset: Optional[torch.Tensor] = None,  # (J, 3)
    locator_offset: Optional[torch.Tensor] = None,  # (J, 3)
    with_landmarks: bool = True,
    use_face_contour: bool = True,
    apply_pose_mean: bool = True,
) -> SMPLXOutput:
    """Run the SMPL-X model for one frame of parameters.

    ``face_offset`` adds to the template before blendshapes; ``joint_offset``
    shifts rest joints feeding both FK and skinning; ``locator_offset``
    shifts only the reported joints. Root-zeroing of ``joint_offset`` is the
    caller's job (prior.apply_joint_offset_weight).
    """
    full_pose = params.full_pose()  # (J, 3)
    if apply_pose_mean:
        full_pose = full_pose + assets.pose_mean.reshape(-1, 3)

    shape_coeffs = torch.cat([params.betas, params.expr], dim=0)
    shapedirs = torch.cat([assets.shapedirs, assets.expr_dirs], dim=-1)

    v_template = assets.v_template
    if face_offset is not None:
        v_template = v_template + face_offset

    rot_mats = axis_angle_to_matrix(full_pose)  # (J, 3, 3)
    verts, joints, A = lbs(
        shape_coeffs, rot_mats, v_template, shapedirs, assets.posedirs,
        assets.joint_regressor, assets.parents, assets.lbs_weights,
        joint_offset=joint_offset, locator_offset=locator_offset,
    )

    landmarks = None
    if with_landmarks:
        lmk_faces_idx = assets.lmk_faces_idx
        lmk_bary = assets.lmk_bary_coords
        if use_face_contour and assets.dyn_lmk_faces_idx.numel() > 0:
            bucket = neck_yaw_bucket(rot_mats, assets.neck_kin_chain)
            lmk_faces_idx = torch.cat([lmk_faces_idx, assets.dyn_lmk_faces_idx[bucket]], dim=0)
            lmk_bary = torch.cat([lmk_bary, assets.dyn_lmk_bary_coords[bucket]], dim=0)
        landmarks = vertices_to_landmarks(verts, assets.faces, lmk_faces_idx, lmk_bary)
        landmarks = landmarks + params.trans[None, :]

    v_shaped = assets.v_template + blend_shapes(params.betas, assets.shapedirs)

    # rest joints actually used by FK (for callers doing inverse-pose math)
    joints_zero = vertices_to_joints(
        assets.joint_regressor, v_template + blend_shapes(shape_coeffs, shapedirs)
    )
    if joint_offset is not None:
        joints_zero = joints_zero + joint_offset

    return SMPLXOutput(
        vertices=verts + params.trans[None, :],
        joints=joints + params.trans[None, :],
        landmarks=landmarks,
        v_shaped=v_shaped,
        joints_zero_pose=joints_zero,
        rel_transforms=A,
    )
