"""Whole-body keypoint tables and extraction for fitting supervision
(counterpart of exavatar_release_tpu/fitting/keypoints.py).

Data constants of the SMPL-X model family (reference
fitting/common/utils/smpl_x.py:40-76 and the smplx package's
VertexJointSelector vertex ids): the 135-keypoint convention = 25 body +
2x20 hand + 70 face keypoints, indexed into the smplx output-joint layout
[55 skeleton joints | 21 selected vertices | 51 static landmarks |
17 contour landmarks].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.smplx.structs import SMPLXAssets, SMPLXOutput

# selected-vertex "joints" appended after the 55 skeleton joints, in smplx
# VertexJointSelector order (vertex ids are SMPL-X topology constants)
SMPLX_EXTRA_JOINT_VERTEX_IDS: Tuple[Tuple[str, int], ...] = (
    ("nose", 9120), ("reye", 9929), ("leye", 9448), ("rear", 616), ("lear", 6),
    ("LBigToe", 5770), ("LSmallToe", 5780), ("LHeel", 8846),
    ("RBigToe", 8463), ("RSmallToe", 8474), ("RHeel", 8635),
    ("lthumb", 5361), ("lindex", 4933), ("lmiddle", 5058), ("lring", 5169),
    ("lpinky", 5286),
    ("rthumb", 8079), ("rindex", 7669), ("rmiddle", 7794), ("rring", 7905),
    ("rpinky", 8022),
)

SMPLX_KPT_NAMES: Tuple[str, ...] = (
    "Pelvis", "L_Hip", "R_Hip", "L_Knee", "R_Knee", "L_Ankle", "R_Ankle",
    "Neck", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow", "L_Wrist",
    "R_Wrist", "L_Big_toe", "L_Small_toe", "L_Heel", "R_Big_toe",
    "R_Small_toe", "R_Heel", "L_Ear", "R_Ear", "L_Eye", "R_Eye", "Nose",
    "L_Thumb_1", "L_Thumb_2", "L_Thumb_3", "L_Thumb_4", "L_Index_1",
    "L_Index_2", "L_Index_3", "L_Index_4", "L_Middle_1", "L_Middle_2",
    "L_Middle_3", "L_Middle_4", "L_Ring_1", "L_Ring_2", "L_Ring_3",
    "L_Ring_4", "L_Pinky_1", "L_Pinky_2", "L_Pinky_3", "L_Pinky_4",
    "R_Thumb_1", "R_Thumb_2", "R_Thumb_3", "R_Thumb_4", "R_Index_1",
    "R_Index_2", "R_Index_3", "R_Index_4", "R_Middle_1", "R_Middle_2",
    "R_Middle_3", "R_Middle_4", "R_Ring_1", "R_Ring_2", "R_Ring_3",
    "R_Ring_4", "R_Pinky_1", "R_Pinky_2", "R_Pinky_3", "R_Pinky_4",
    "Head", "Jaw",
) + tuple(f"Face_{i}" for i in range(1, 69))

# row in [joints55 | extra21 | landmarks68] per keypoint (reference
# fitting/common/utils/smpl_x.py:47-63)
SMPLX_KPT_IDX: Tuple[int, ...] = (
    0, 1, 2, 4, 5, 7, 8, 12, 16, 17, 18, 19, 20, 21, 60, 61, 62, 63, 64, 65,
    59, 58, 57, 56, 55,
    37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68, 34, 35, 36, 69, 31, 32,
    33, 70,
    52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73, 49, 50, 51, 74, 46, 47,
    48, 75,
    15, 22,
    76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89,
    90, 91, 92, 93, 94,
    95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106,
    107,
    108, 109, 110, 111, 112,
    113,
    114, 115, 116, 117, 118,
    119,
    120, 121, 122,
    123,
    124, 125, 126,
    127, 128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138, 139, 140,
    141, 142, 143,
)

KPT_ROOT_IDX = SMPLX_KPT_NAMES.index("Pelvis")
KPT_PART_IDX: Dict[str, Tuple[int, ...]] = {
    "body": tuple(range(0, 25)),
    "lhand": tuple(range(25, 45)),
    "rhand": tuple(range(45, 65)),
    "face": (7, 65, 66, 22, 23) + tuple(range(67, 135)) + (20, 21),
}


def extra_joint_ids_for(assets: SMPLXAssets) -> np.ndarray:
    """Vertex-selector ids, clipped into range for synthetic meshes (real
    assets have V=10475 so the real constants apply verbatim)."""
    ids = np.asarray([v for _, v in SMPLX_EXTRA_JOINT_VERTEX_IDS], np.int64)
    return np.clip(ids, 0, assets.num_vertices - 1)


def full_keypoints(
    out: SMPLXOutput,
    assets: SMPLXAssets,
    extra_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(135, 3) camera-space keypoints from a forward output with landmarks
    (landmarks must include the 17-point contour)."""
    dev = out.vertices.device
    if extra_ids is None:
        extra_ids = torch.from_numpy(extra_joint_ids_for(assets)).to(dev)
    rows = torch.cat([out.joints, out.vertices[extra_ids.long()], out.landmarks], dim=0)
    return rows[torch.tensor(SMPLX_KPT_IDX, device=dev)]


# the FLAME keypoint layout: (Neck, Head, Jaw, L_Eye, R_Eye, Face_1..68,
# L_Ear, R_Ear), from the FLAME forward's joints, landmarks and ear vertices
FLAME_KPT_NUM = 75


def flame_full_keypoints(out: SMPLXOutput, lear_vertex_idx: int,
                         rear_vertex_idx: int) -> torch.Tensor:
    """(75, 3): [neck (global), head (neck joint), jaw, leye, reye, Face_1..68
    landmarks, lear, rear]."""
    lear = out.vertices[lear_vertex_idx][None]
    rear = out.vertices[rear_vertex_idx][None]
    return torch.cat([out.joints, out.landmarks, lear, rear], dim=0)
