"""SMPL-X prior: part masks, cavity, 大-pose constants, 2x subdivision
(counterpart of exavatar_release_tpu/models/smplx/prior.py).

Everything is precomputed once by ``build_prior``; the per-subject identity
info is a separate ``SMPLXIDInfo`` passed explicitly through the model.
This slice derives the part tables from the assets themselves (the
synthetic path); loading the released correspondence files waits for the
apps slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .structs import SMPLX_JOINT_NAMES, SMPLXAssets
from .subdivide import SubdivisionOp, build_subdivision, upsample_features

# lip vertices of the real SMPL-X topology used to close the mouth cavity
REAL_LIP_VERTEX_IDX = (2844, 2855, 8977, 1740, 1730, 1789, 8953, 2892)
# triangles over the 8 lip vertices
CAVITY_FACE_PATTERN = ((0, 1, 7), (1, 2, 7), (2, 3, 5), (3, 4, 5), (2, 5, 6), (2, 6, 7))

JOINT_PART = {
    "body": tuple(range(0, 22)),
    "face": tuple(range(22, 25)),
    "lhand": tuple(range(25, 40)),
    "rhand": tuple(range(40, 55)),
}
ROOT_JOINT_IDX = 0


@dataclasses.dataclass(frozen=True)
class SMPLXIDInfo:
    """Per-subject identity parameters."""

    shape_param: torch.Tensor  # (S,)
    face_offset: torch.Tensor  # (V, 3)
    joint_offset: torch.Tensor  # (J, 3)
    locator_offset: torch.Tensor  # (J, 3)

    @staticmethod
    def zeros(num_shape: int, num_verts: int, num_joints: int,
              device="cuda") -> "SMPLXIDInfo":
        return SMPLXIDInfo(
            shape_param=torch.zeros(num_shape, device=device),
            face_offset=torch.zeros(num_verts, 3, device=device),
            joint_offset=torch.zeros(num_joints, 3, device=device),
            locator_offset=torch.zeros(num_joints, 3, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SMPLXPrior:
    """Precomputed prior around an ``SMPLXAssets``."""

    assets: SMPLXAssets
    faces_with_cavity: torch.Tensor  # (F+6, 3) int32
    is_cavity: torch.Tensor  # (V,) float {0,1} on low-res verts
    face_vertex_idx: torch.Tensor  # (Nf,) int32
    lhand_vertex_idx: torch.Tensor
    rhand_vertex_idx: torch.Tensor
    expr_vertex_idx: torch.Tensor  # face verts driven by expression
    neutral_body_pose: torch.Tensor  # (21, 3) 大-pose axis-angle
    neutral_jaw_pose: torch.Tensor  # (3,)
    subdividers: Tuple[SubdivisionOp, ...]
    faces_upsampled: torch.Tensor  # (F_hr, 3) int32
    is_rhand_hr: torch.Tensor  # (V_hr,) bool
    is_lhand_hr: torch.Tensor
    is_face_hr: torch.Tensor
    is_face_expr_hr: torch.Tensor
    is_cavity_hr: torch.Tensor
    vertex_num_upsampled: int

    def upsample_mesh(self, feats: torch.Tensor) -> torch.Tensor:
        """Carry per-vertex features through every subdivision level."""
        return upsample_features(list(self.subdividers), feats)

    def apply_joint_offset_weight(self, joint_offset: torch.Tensor) -> torch.Tensor:
        """Zero the root row."""
        out = joint_offset.clone()
        out[ROOT_JOINT_IDX] = 0.0
        return out


def _derive_part_tables(lbs_weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hand/face vertex tables from the skinning argmax."""
    nearest = lbs_weights.argmax(1)
    lhand = np.where(np.isin(nearest, JOINT_PART["lhand"]))[0]
    rhand = np.where(np.isin(nearest, JOINT_PART["rhand"]))[0]
    head_set = [SMPLX_JOINT_NAMES.index(n) for n in ("Head", "Jaw", "L_Eye", "R_Eye")]
    face = np.where(np.isin(nearest, head_set))[0]
    return lhand.astype(np.int32), rhand.astype(np.int32), face.astype(np.int32)


def _derive_expr_vertex_idx(expr_dirs: np.ndarray, lbs_weights: np.ndarray) -> np.ndarray:
    """Expression-driven face vertices: the expr_dirs support of the model
    minus eye/neck-dominated vertices."""
    support = np.abs(expr_dirs).sum((1, 2)) > 0
    nearest = lbs_weights.argmax(1)
    eye_set = [SMPLX_JOINT_NAMES.index(n) for n in ("L_Eye", "R_Eye", "Neck")]
    keep = support & ~np.isin(nearest, eye_set)
    return np.where(keep)[0].astype(np.int32)


def build_prior(assets: SMPLXAssets, subdivide_levels: int = 2) -> SMPLXPrior:
    """Precompute the prior on the assets' device, deriving every table from
    the skinning weights and blendshape support."""
    device = assets.v_template.device
    V = assets.num_vertices
    faces = assets.faces.cpu().numpy().astype(np.int64)
    w = assets.lbs_weights.cpu().numpy()

    if V > max(REAL_LIP_VERTEX_IDX):
        lip_vertex_idx = REAL_LIP_VERTEX_IDX
    else:
        # small meshes: 8 face-region verts nearest the jaw joint
        jaw = SMPLX_JOINT_NAMES.index("Jaw")
        lip_vertex_idx = tuple(np.argsort(-w[:, jaw])[:8].astype(int).tolist())

    is_cavity = np.zeros((V,), np.float32)
    is_cavity[list(lip_vertex_idx)] = 1.0
    cavity_faces = np.array(
        [[lip_vertex_idx[a], lip_vertex_idx[b], lip_vertex_idx[c]]
         for a, b, c in CAVITY_FACE_PATTERN],
        np.int64,
    )
    faces_with_cavity = np.concatenate([faces, cavity_faces], axis=0).astype(np.int32)

    lhand_idx, rhand_idx, face_idx = _derive_part_tables(w)
    expr_idx = _derive_expr_vertex_idx(assets.expr_dirs.cpu().numpy(), w)

    # 大 pose: legs split, mouth open
    neutral_body_pose = np.zeros((21, 3), np.float32)
    neutral_body_pose[0] = (0.0, 0.0, 1.0)
    neutral_body_pose[1] = (0.0, 0.0, -1.0)
    neutral_jaw_pose = np.array([1.0 / 3.0, 0.0, 0.0], np.float32)

    ops, faces_hr, v_hr = build_subdivision(faces_with_cavity, V, subdivide_levels, device)

    def upsampled_mask(m):
        return upsample_features(ops, torch.from_numpy(m).to(device)[:, None])[:, 0] > 0

    def mask_from_idx(idx):
        m = np.zeros((V,), np.float32)
        m[np.asarray(idx, np.int64)] = 1.0
        return upsampled_mask(m)

    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return SMPLXPrior(
        assets=assets,
        faces_with_cavity=t(faces_with_cavity),
        is_cavity=t(is_cavity),
        face_vertex_idx=t(face_idx),
        lhand_vertex_idx=t(lhand_idx),
        rhand_vertex_idx=t(rhand_idx),
        expr_vertex_idx=t(expr_idx),
        neutral_body_pose=t(neutral_body_pose),
        neutral_jaw_pose=t(neutral_jaw_pose),
        subdividers=tuple(ops),
        faces_upsampled=t(faces_hr),
        is_rhand_hr=mask_from_idx(rhand_idx),
        is_lhand_hr=mask_from_idx(lhand_idx),
        is_face_hr=mask_from_idx(face_idx),
        is_face_expr_hr=mask_from_idx(expr_idx),
        is_cavity_hr=upsampled_mask(is_cavity),
        vertex_num_upsampled=int(v_hr),
    )
