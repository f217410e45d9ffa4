"""Optimizable fitting parameters + per-part weighting (counterpart of
exavatar_release_tpu/fitting/params.py).

Mirrors the parameter registration of the reference fit loop (reference
fitting/main/fit.py:37-62): per-frame SMPL-X poses (root/body/hands, 6D) and
translations; per-frame FLAME poses; jaw/eye poses and expression SHARED
between the two models (single tensors); shared identity (SMPL-X shape,
FLAME shape, face/joint/locator offsets). ``FittingParams`` is a dataclass
of tensors whose fields are the JAX dataclass's, in its order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.rotations import axis_angle_to_rotation_6d
from ..models.smplx.structs import SMPLX_JOINT_NAMES

ROOT_IDX = SMPLX_JOINT_NAMES.index("Pelvis")
LHIP_IDX = SMPLX_JOINT_NAMES.index("L_Hip")
RHIP_IDX = SMPLX_JOINT_NAMES.index("R_Hip")


@dataclasses.dataclass
class FittingParams:
    """All optimizable state for a batch of F frames."""

    # per-frame SMPL-X (6D poses)
    smplx_root_pose: torch.Tensor  # (F, 6)
    smplx_body_pose: torch.Tensor  # (F, 21, 6)
    smplx_lhand_pose: torch.Tensor  # (F, 15, 6)
    smplx_rhand_pose: torch.Tensor  # (F, 15, 6)
    smplx_trans: torch.Tensor  # (F, 3)
    # shared face params (used by BOTH models; reference fit.py:54-57)
    jaw_pose: torch.Tensor  # (F, 6)
    leye_pose: torch.Tensor  # (F, 6)
    reye_pose: torch.Tensor  # (F, 6)
    expr: torch.Tensor  # (F, E)
    # per-frame FLAME
    flame_root_pose: torch.Tensor  # (F, 6)
    flame_neck_pose: torch.Tensor  # (F, 6)
    flame_trans: torch.Tensor  # (F, 3)
    # shared identity
    smplx_shape: torch.Tensor  # (S,)
    flame_shape: torch.Tensor  # (S,)
    face_offset: torch.Tensor  # (V_flame, 3) on FLAME-correspondence verts
    joint_offset: torch.Tensor  # (J, 3)
    locator_offset: torch.Tensor  # (J, 3)

    def named(self) -> Dict[str, torch.Tensor]:
        """{leaf name: tensor}, in field order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


LEAVES: Tuple[str, ...] = tuple(f.name for f in dataclasses.fields(FittingParams))


def init_fitting_params(
    smplx_init: Sequence[Dict[str, np.ndarray]],
    flame_init: Sequence[Dict[str, np.ndarray]],
    flame_shape: np.ndarray,
    num_shape: int,
    num_flame_verts: int,
    num_joints: int,
    device="cuda",
) -> FittingParams:
    """Encode initial per-frame estimates (Hand4Whole / DECA outputs, the
    same JSON payloads the reference datasets load)."""
    enc = axis_angle_to_rotation_6d

    def stack(payloads, key, shape):
        return torch.from_numpy(np.stack(
            [np.asarray(p[key], np.float32).reshape(shape) for p in payloads])).to(device)

    s = lambda key, shape: stack(smplx_init, key, shape)
    f = lambda key, shape: stack(flame_init, key, shape)
    z = lambda *shape: torch.zeros(shape, device=device)
    E = np.asarray(flame_init[0]["expr"]).reshape(-1).shape[0]
    return FittingParams(
        smplx_root_pose=enc(s("root_pose", (3,))),
        smplx_body_pose=enc(s("body_pose", (21, 3))),
        smplx_lhand_pose=enc(s("lhand_pose", (15, 3))),
        smplx_rhand_pose=enc(s("rhand_pose", (15, 3))),
        smplx_trans=s("trans", (3,)),
        jaw_pose=enc(f("jaw_pose", (3,))),
        leye_pose=enc(f("leye_pose", (3,))),
        reye_pose=enc(f("reye_pose", (3,))),
        expr=f("expr", (E,)),
        flame_root_pose=enc(f("root_pose", (3,))),
        flame_neck_pose=enc(f("neck_pose", (3,))),
        flame_trans=f("trans", (3,)),
        smplx_shape=z(num_shape),
        flame_shape=torch.from_numpy(np.asarray(flame_shape, np.float32).reshape(-1)).to(device),
        face_offset=z(num_flame_verts, 3),
        joint_offset=z(num_joints, 3),
        locator_offset=z(num_joints, 3),
    )


def scatter_winners(face_vertex_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, targets) of the scatter ``full[face_vertex_idx] = face_offset``:
    each target vertex once, with the LAST row that writes it. The
    correspondence may repeat a vertex (the synthetic one pads with its last
    index); JAX's scatter on the CPU keeps the last write and gives the
    gradient to it alone, and so does this one, on any device."""
    idx = np.asarray(face_vertex_idx, np.int64)
    rev_targets, rev_first = np.unique(idx[::-1], return_index=True)
    return (idx.size - 1 - rev_first).astype(np.int64), rev_targets.astype(np.int64)


def pad_face_offset(face_offset: torch.Tensor, winners: Tuple[torch.Tensor, torch.Tensor],
                    num_vertices: int) -> torch.Tensor:
    """Scatter FLAME-correspondence offsets into the full SMPL-X vertex set
    (reference smpl_x.get_face_offset, fitting smpl_x.py:84-88) through the
    ``scatter_winners`` of the correspondence."""
    rows, targets = winners
    full = torch.zeros((num_vertices, 3), dtype=face_offset.dtype, device=face_offset.device)
    return full.index_copy(0, targets, face_offset[rows])


def weight_joint_offset(joint_offset: torch.Tensor) -> torch.Tensor:
    """Zero root + both hips (reference fitting smpl_x.get_joint_offset,
    :90-96 — hips are handled by the locator offset instead)."""
    idx = torch.tensor([ROOT_IDX, LHIP_IDX, RHIP_IDX], device=joint_offset.device)
    return joint_offset.index_fill(0, idx, 0.0)


def weight_locator_offset(locator_offset: torch.Tensor) -> torch.Tensor:
    """Keep ONLY the hips (reference get_locator_offset, :98-103)."""
    keep = torch.zeros(locator_offset.shape[0], dtype=torch.bool, device=locator_offset.device)
    keep[[LHIP_IDX, RHIP_IDX]] = True
    return torch.where(keep[:, None], locator_offset, 0.0)


def stage_mask_tree(root_only: bool, allow_shared: bool) -> FittingParams:
    """Gradient multipliers (1.0 or 0.0 per leaf) implementing the
    reference's stage-dependent optimizer membership (fit.py:73-96):
    root_only -> only root poses + translations; allow_shared gates the
    shared identity params (frozen in the final epoch)."""
    per_frame = 0.0 if root_only else 1.0
    shared = 0.0 if root_only or not allow_shared else 1.0
    return FittingParams(
        smplx_root_pose=1.0, smplx_trans=1.0,
        flame_root_pose=1.0, flame_trans=1.0,
        smplx_body_pose=per_frame, smplx_lhand_pose=per_frame,
        smplx_rhand_pose=per_frame,
        jaw_pose=per_frame, leye_pose=per_frame, reye_pose=per_frame,
        expr=per_frame, flame_neck_pose=per_frame,
        smplx_shape=shared, flame_shape=shared, face_offset=shared,
        joint_offset=shared, locator_offset=shared,
    )
