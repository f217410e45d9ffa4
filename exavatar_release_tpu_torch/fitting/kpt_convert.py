"""Keypoint-convention conversion: COCO-WholeBody-133 -> SMPL-X-135
(counterpart of exavatar_release_tpu/fitting/kpt_convert.py, numpy only).

Data constants + name-matching conversion of the reference
(reference fitting/data/Custom/Custom.py:21-28 name table and
fitting/common/utils/transforms.py change_kpt_name:24-35): detector
keypoints (mmpose RTMPose whole-body order) map by NAME into the 135-kpt
SMPL-X supervision convention; unmatched targets stay zero (invalid).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# mmpose COCO-WholeBody 133-keypoint order (reference Custom.py:21-28)
COCO_WHOLEBODY_133_NAMES: Tuple[str, ...] = (
    "Nose", "L_Eye", "R_Eye", "L_Ear", "R_Ear", "L_Shoulder", "R_Shoulder",
    "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hip", "R_Hip", "L_Knee",
    "R_Knee", "L_Ankle", "R_Ankle", "L_Big_toe", "L_Small_toe", "L_Heel",
    "R_Big_toe", "R_Small_toe", "R_Heel",
) + tuple(f"Face_{i}" for i in range(52, 69)) \
  + tuple(f"Face_{i}" for i in range(1, 52)) + (
    "L_Wrist_Hand", "L_Thumb_1", "L_Thumb_2", "L_Thumb_3", "L_Thumb_4",
    "L_Index_1", "L_Index_2", "L_Index_3", "L_Index_4", "L_Middle_1",
    "L_Middle_2", "L_Middle_3", "L_Middle_4", "L_Ring_1", "L_Ring_2",
    "L_Ring_3", "L_Ring_4", "L_Pinky_1", "L_Pinky_2", "L_Pinky_3",
    "L_Pinky_4",
    "R_Wrist_Hand", "R_Thumb_1", "R_Thumb_2", "R_Thumb_3", "R_Thumb_4",
    "R_Index_1", "R_Index_2", "R_Index_3", "R_Index_4", "R_Middle_1",
    "R_Middle_2", "R_Middle_3", "R_Middle_4", "R_Ring_1", "R_Ring_2",
    "R_Ring_3", "R_Ring_4", "R_Pinky_1", "R_Pinky_2", "R_Pinky_3",
    "R_Pinky_4",
)


def change_kpt_name(
    src_kpt: np.ndarray,
    src_names: Sequence[str],
    dst_names: Sequence[str],
) -> np.ndarray:
    """Rearrange (K_src, C) keypoints by name into (K_dst, C); missing
    targets are zero rows (reference transforms.change_kpt_name)."""
    out = np.zeros((len(dst_names),) + src_kpt.shape[1:], np.float32)
    dst_index = {n: i for i, n in enumerate(dst_names)}
    for i, name in enumerate(src_names):
        j = dst_index.get(name)
        if j is not None:
            out[j] = src_kpt[i]
    return out


def coco133_to_smplx135(kpt133: np.ndarray) -> np.ndarray:
    """(133, 3) detector keypoints -> (135, 3) SMPL-X convention."""
    from .keypoints import SMPLX_KPT_NAMES

    assert kpt133.shape[0] == 133, kpt133.shape
    return change_kpt_name(kpt133, COCO_WHOLEBODY_133_NAMES, SMPLX_KPT_NAMES)
