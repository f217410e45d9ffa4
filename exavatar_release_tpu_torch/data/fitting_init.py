"""Fitting initialization: detector outputs -> initial SMPL-X/FLAME params
(counterpart of exavatar_release_tpu/data/fitting_init.py).

Semantics of the reference fitting datasets' shared init logic (reference
fitting/data/Custom/Custom.py:122-159 and fitting/data/XHumans/
XHumans.py:119-155): bbox-derived initial body translation, Umeyama rigid
alignment of the FLAME template onto the SMPL-X face region for the initial
FLAME root pose/translation, plus the XHumans pkl layout loader.

Every function takes and returns numpy arrays and runs on the host: the 3x3
algebra (the rotations and the Umeyama SVD) goes through float32 CPU tensors.
"""
from __future__ import annotations

import math
import os.path as osp
import pickle
from glob import glob
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.geometry import umeyama
from ..core.rotations import axis_angle_to_matrix, matrix_to_axis_angle
from .subject import bbox_from_keypoints


def _f32(x) -> torch.Tensor:
    """A float32 CPU tensor of ``x``, as ``jnp.asarray`` makes it."""
    return torch.from_numpy(np.array(x, np.float32))


def set_aspect_ratio(bbox: np.ndarray, aspect: float = 1.0) -> np.ndarray:
    """Expand the bbox to a fixed aspect ratio around its center (reference
    preprocessing.set_aspect_ratio semantics: widen the short side)."""
    x, y, w, h = bbox
    cx, cy = x + w / 2.0, y + h / 2.0
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return np.asarray([cx - w / 2.0, cy - h / 2.0, w, h], np.float32)


def smplx_trans_init(
    kpt: np.ndarray,
    focal: np.ndarray,
    princpt: np.ndarray,
    body_3d_size: float = 2.0,
    conf_thr: float = 0.2,
) -> np.ndarray:
    """Initial body translation from the keypoint bbox (reference
    get_smplx_trans_init: z from the pinhole size relation
    t_z = sqrt(fx*fy*s²/(w*h)), x/y by back-projecting the bbox center)."""
    valid = (kpt[:, 2] > conf_thr).astype(np.float32)
    bbox = set_aspect_ratio(bbox_from_keypoints(kpt[:, :2], valid))
    area = max(float(bbox[2] * bbox[3]), 1e-6)
    t_z = math.sqrt(float(focal[0]) * float(focal[1]) * body_3d_size ** 2 / area)
    t_x = (bbox[0] + bbox[2] / 2.0 - princpt[0]) / focal[0] * t_z
    t_y = (bbox[1] + bbox[3] / 2.0 - princpt[1]) / focal[1] * t_z
    return np.asarray([t_x, t_y, t_z], np.float32)


def flame_root_init(
    smplx_root_pose_aa: np.ndarray,
    smplx_trans: np.ndarray,
    smplx_v_template: np.ndarray,
    face_vertex_idx: np.ndarray,
    flame_v_template: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial FLAME (root_pose, trans) by rigidly aligning the FLAME
    template to the root-posed SMPL-X face region (reference
    get_flame_root_init via pytorch3d corresponding_points_alignment)."""
    R0 = axis_angle_to_matrix(_f32(smplx_root_pose_aa)).numpy()
    sm = smplx_v_template @ R0.T
    sm = sm - sm.mean(0)[None] + smplx_trans[None]
    target = sm[face_vertex_idx]

    R, _, _ = umeyama(_f32(flame_v_template), _f32(target), estimate_scale=False)
    rotated = flame_v_template @ R.numpy().T
    root_pose = matrix_to_axis_angle(R).numpy()
    trans = -rotated.mean(0) + target.mean(0)
    return root_pose.astype(np.float32), trans.astype(np.float32)


def load_xhumans_smplx_init(root_path: str) -> Dict[int, Dict[str, np.ndarray]]:
    """XHumans SMPLX/*.pkl layout (reference XHumans.py:80-97: frame index
    parsed from '...-fNNNNN_...' names, torch-smplx key naming)."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for p in glob(osp.join(root_path, "SMPLX", "*.pkl")):
        frame_idx = int(osp.basename(p).split("-")[1].split("_")[0][1:])
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        out[frame_idx] = {
            "root_pose": np.asarray(d["global_orient"], np.float32).reshape(3),
            "body_pose": np.asarray(d["body_pose"], np.float32).reshape(-1, 3),
            "jaw_pose": np.asarray(d["jaw_pose"], np.float32).reshape(3),
            "leye_pose": np.asarray(d["leye_pose"], np.float32).reshape(3),
            "reye_pose": np.asarray(d["reye_pose"], np.float32).reshape(3),
            "lhand_pose": np.asarray(d["left_hand_pose"], np.float32).reshape(-1, 3),
            "rhand_pose": np.asarray(d["right_hand_pose"], np.float32).reshape(-1, 3),
            "trans": np.asarray(d.get("transl", np.zeros(3)), np.float32).reshape(3),
        }
    return out


def world_to_cam_root_pose(root_pose_aa: np.ndarray, cam_R: np.ndarray) -> np.ndarray:
    """Rotate a world-frame root pose into the camera frame (reference
    XHumans.py:107-111)."""
    R0 = axis_angle_to_matrix(_f32(root_pose_aa)).numpy()
    return matrix_to_axis_angle(_f32(cam_R.astype(np.float32) @ R0)).numpy().astype(np.float32)


def crop_camera_intrinsics(
    focal: np.ndarray,
    princpt: np.ndarray,
    bbox: np.ndarray,
    out_shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Rescale pinhole intrinsics so projection lands directly in a bbox
    crop resized to ``out_shape`` (reference Custom.py:199-206: the fitting
    supervision space and the face-crop camera)."""
    out_h, out_w = out_shape
    f = np.asarray([focal[0] / bbox[2] * out_w, focal[1] / bbox[3] * out_h], np.float32)
    # NOTE the reference scales BOTH principal components by out_w/bbox[2|3]
    # (proj_shape is square there); we keep its exact algebra
    p = np.asarray([(princpt[0] - bbox[0]) / bbox[2] * out_w,
                    (princpt[1] - bbox[1]) / bbox[3] * out_w], np.float32)
    return f, p


def keypoints_to_crop(kpt_xy: np.ndarray, bbox: np.ndarray,
                      out_shape: Tuple[int, int]) -> np.ndarray:
    """Affine-map image-space keypoints into the bbox crop space
    (reference get_patch_img affine, Custom.py:186-188)."""
    out_h, out_w = out_shape
    x = (kpt_xy[:, 0] - bbox[0]) / bbox[2] * out_w
    y = (kpt_xy[:, 1] - bbox[1]) / bbox[3] * out_h
    return np.stack([x, y], axis=1).astype(np.float32)
