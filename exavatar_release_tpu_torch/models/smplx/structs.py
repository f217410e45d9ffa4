"""SMPL-X data structures (counterpart of
exavatar_release_tpu/models/smplx/structs.py).

Assets and per-frame parameters are dataclasses of tensors; the kinematic
tree (``parents``) is a plain tuple so FK unrolls in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SMPLXAssets:
    """SMPL-X model data. V = vertices, J = joints (55), S = shape dims,
    E = expression dims, P = 9*(J-1)."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, S)
    expr_dirs: torch.Tensor  # (V, 3, E)
    posedirs: torch.Tensor  # (P, V*3) pose-corrective basis
    joint_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    pose_mean: torch.Tensor  # (J*3,) axis-angle added to the full pose
    faces: torch.Tensor  # (F, 3) int32 triangle indices
    lmk_faces_idx: torch.Tensor  # (L,) int32 static landmark faces
    lmk_bary_coords: torch.Tensor  # (L, 3)
    dyn_lmk_faces_idx: torch.Tensor  # (79, 17) int32 contour LUT by neck yaw
    dyn_lmk_bary_coords: torch.Tensor  # (79, 17, 3)
    parents: Tuple[int, ...]
    neck_kin_chain: Tuple[int, ...]

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_shape(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return self.expr_dirs.shape[-1]


SMPLX_JOINT_NAMES: Tuple[str, ...] = (
    "Pelvis", "L_Hip", "R_Hip", "Spine_1", "L_Knee", "R_Knee", "Spine_2",
    "L_Ankle", "R_Ankle", "Spine_3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist",
    "Jaw", "L_Eye", "R_Eye",
    "L_Index_1", "L_Index_2", "L_Index_3", "L_Middle_1", "L_Middle_2",
    "L_Middle_3", "L_Pinky_1", "L_Pinky_2", "L_Pinky_3", "L_Ring_1",
    "L_Ring_2", "L_Ring_3", "L_Thumb_1", "L_Thumb_2", "L_Thumb_3",
    "R_Index_1", "R_Index_2", "R_Index_3", "R_Middle_1", "R_Middle_2",
    "R_Middle_3", "R_Pinky_1", "R_Pinky_2", "R_Pinky_3", "R_Ring_1",
    "R_Ring_2", "R_Ring_3", "R_Thumb_1", "R_Thumb_2", "R_Thumb_3",
)

# kinematic tree of the standard SMPL-X skeleton
SMPLX_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,  # jaw, leye, reye <- head
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
)

# neck->head chain of the dynamic-contour landmark LUT
SMPLX_NECK_KIN_CHAIN: Tuple[int, ...] = (15, 12, 9, 6, 3, 0)

NUM_BODY_JOINTS = 21  # body joints excluding pelvis/root
NUM_HAND_JOINTS = 15


@dataclasses.dataclass(frozen=True)
class SMPLXParams:
    """One frame of SMPL-X parameters, axis-angle rotations, no batch dim."""

    betas: torch.Tensor  # (S,)
    expr: torch.Tensor  # (E,)
    root_pose: torch.Tensor  # (3,)
    body_pose: torch.Tensor  # (21, 3)
    jaw_pose: torch.Tensor  # (3,)
    leye_pose: torch.Tensor  # (3,)
    reye_pose: torch.Tensor  # (3,)
    lhand_pose: torch.Tensor  # (15, 3)
    rhand_pose: torch.Tensor  # (15, 3)
    trans: torch.Tensor  # (3,)

    @staticmethod
    def zeros(num_shape: int = 100, num_expr: int = 50,
              device="cuda") -> "SMPLXParams":
        z = lambda *shape: torch.zeros(shape, device=device)
        return SMPLXParams(
            betas=z(num_shape), expr=z(num_expr), root_pose=z(3),
            body_pose=z(NUM_BODY_JOINTS, 3), jaw_pose=z(3), leye_pose=z(3),
            reye_pose=z(3), lhand_pose=z(NUM_HAND_JOINTS, 3),
            rhand_pose=z(NUM_HAND_JOINTS, 3), trans=z(3),
        )

    def replace(self, **kw) -> "SMPLXParams":
        return dataclasses.replace(self, **kw)

    def full_pose(self) -> torch.Tensor:
        """(J, 3) axis-angle in model joint order."""
        return torch.cat(
            [
                self.root_pose.reshape(1, 3),
                self.body_pose.reshape(NUM_BODY_JOINTS, 3),
                self.jaw_pose.reshape(1, 3),
                self.leye_pose.reshape(1, 3),
                self.reye_pose.reshape(1, 3),
                self.lhand_pose.reshape(NUM_HAND_JOINTS, 3),
                self.rhand_pose.reshape(NUM_HAND_JOINTS, 3),
            ],
            dim=0,
        )


@dataclasses.dataclass(frozen=True)
class SMPLXOutput:
    vertices: torch.Tensor  # (V, 3) posed, translated
    joints: torch.Tensor  # (J, 3) posed joints (with locator offset if given)
    landmarks: Optional[torch.Tensor]  # (L(+17), 3) face landmarks or None
    v_shaped: torch.Tensor  # (V, 3) template + shape blendshapes (no expr)
    joints_zero_pose: torch.Tensor  # (J, 3) rest joints used by FK
    rel_transforms: torch.Tensor  # (J, 4, 4) FK skinning transforms A
