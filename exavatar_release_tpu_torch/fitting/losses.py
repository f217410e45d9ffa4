"""Fitting losses (counterpart of exavatar_release_tpu/fitting/losses.py;
reference fitting/common/nets/loss.py).

Every per-frame function works on one frame (the reference's Python loop
over the batch in CoordLoss, loss.py:54-71, is vectorized), so the whole
loss stack maps over frames with ``torch.func.vmap`` (fitting/model.py).
Every L1 term takes ``abs_as_jax``: at exactly zero (offsets and poses that
start where their priors are) its gradient is JAX's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..avatar.losses import abs_as_jax
from ..core.rotations import axis_angle_to_matrix
from .keypoints import KPT_PART_IDX, SMPLX_KPT_NAMES

_LWRIST = SMPLX_KPT_NAMES.index("L_Wrist")
_RWRIST = SMPLX_KPT_NAMES.index("R_Wrist")


def _kpt_bbox(kpt: torch.Tensor, valid: torch.Tensor, extend: float = 1.2) -> torch.Tensor:
    """[xmin, ymin, w, h] of valid keypoints, extended (reference
    loss.py:13-27). kpt: (K, 2); valid: (K, 1)."""
    v = valid[:, 0] > 0
    big = 1e9
    xmin = torch.min(torch.where(v, kpt[:, 0], big))
    ymin = torch.min(torch.where(v, kpt[:, 1], big))
    xmax = torch.max(torch.where(v, kpt[:, 0], -big))
    ymax = torch.max(torch.where(v, kpt[:, 1], -big))
    cx = (xmin + xmax) / 2.0
    cy = (ymin + ymax) / 2.0
    w = (xmax - xmin) * extend
    h = (ymax - ymin) * extend
    return torch.stack([cx - w / 2.0, cy - h / 2.0, w, h])


def _bbox_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU of [x, y, w, h] boxes (reference loss.py:29-46)."""
    x1a, y1a, x2a, y2a = b1[0], b1[1], b1[0] + b1[2], b1[1] + b1[3]
    x1b, y1b, x2b, y2b = b2[0], b2[1], b2[0] + b2[2], b2[1] + b2[3]
    xi = torch.maximum(x1a, x1b)
    yi = torch.maximum(y1a, y1b)
    xa = torch.minimum(x2a, x2b)
    ya = torch.minimum(y2a, y2b)
    inter = torch.clamp(xa - xi, min=0.0) * torch.clamp(ya - yi, min=0.0)
    a1 = (x2a - x1a) * (y2a - y1a)
    a2 = (x2b - x1b) * (y2b - y1b)
    return inter / (a1 + a2 - inter + 1e-5)


def _part_rows(part: str, wrist: int, num_kpt: int, device) -> torch.Tensor:
    """(K,) bool: the part's keypoints and its wrist."""
    rows = torch.zeros(num_kpt, dtype=torch.bool, device=device)
    rows[list(KPT_PART_IDX[part]) + [wrist]] = True
    return rows


def hand_occlusion_weight(
    kpt_proj: torch.Tensor, kpt_valid: torch.Tensor, kpt_cam: torch.Tensor
) -> torch.Tensor:
    """(K, 1) weight zeroing the farther hand when L/R hand boxes overlap
    (IoU > 0.5) — detectors confuse overlapping hands (reference
    loss.py:54-71). Single frame; detached."""
    kpt_proj, kpt_cam = kpt_proj.detach(), kpt_cam.detach()
    dev, K = kpt_proj.device, kpt_proj.shape[0]
    l_idx = torch.tensor(KPT_PART_IDX["lhand"], device=dev)
    r_idx = torch.tensor(KPT_PART_IDX["rhand"], device=dev)
    lv = kpt_valid[l_idx]
    rv = kpt_valid[r_idx]
    has_both = (torch.sum(lv) > 0) & (torch.sum(rv) > 0)
    iou = _bbox_iou(_kpt_bbox(kpt_proj[l_idx], lv), _kpt_bbox(kpt_proj[r_idx], rv))
    l_farther = torch.mean(kpt_cam[l_idx, 2]) > torch.mean(kpt_cam[r_idx, 2])
    drop = has_both & (iou > 0.5)
    zero = ((drop & l_farther) & _part_rows("lhand", _LWRIST, K, dev)) \
        | ((drop & ~l_farther) & _part_rows("rhand", _RWRIST, K, dev))
    return torch.where(zero, 0.0, 1.0)[:, None]


def coord_loss(
    kpt_proj: torch.Tensor,
    kpt_proj_gt: torch.Tensor,
    kpt_valid: torch.Tensor,
    kpt_cam: torch.Tensor,
) -> torch.Tensor:
    """|proj - gt| * valid * occlusion weight (reference CoordLoss.forward,
    loss.py:73-75). Single frame (K, 2)."""
    w = hand_occlusion_weight(kpt_proj, kpt_valid, kpt_cam)
    return abs_as_jax(kpt_proj - kpt_proj_gt) * kpt_valid * w


def pose_loss(pose_out_aa: torch.Tensor, pose_gt_aa: torch.Tensor) -> torch.Tensor:
    """|R(out) - R(gt)| elementwise (reference PoseLoss, loss.py:77-91)."""
    return abs_as_jax(axis_angle_to_matrix(pose_out_aa) - axis_angle_to_matrix(pose_gt_aa))


def edge_length_loss(
    coord_out: torch.Tensor,
    coord_gt: torch.Tensor,
    valid: torch.Tensor,
    faces: torch.Tensor,
) -> torch.Tensor:
    """|edge lengths out - gt| on valid edges (reference EdgeLengthLoss,
    loss.py:120-146). Single mesh (V, 3); valid (V, 1)."""
    faces = faces.long()

    def lengths(c):
        a = c[faces[:, 0]]
        b = c[faces[:, 1]]
        d = c[faces[:, 2]]
        e1 = torch.sqrt(torch.sum((a - b) ** 2, 1, keepdim=True) + 1e-12)
        e2 = torch.sqrt(torch.sum((a - d) ** 2, 1, keepdim=True) + 1e-12)
        e3 = torch.sqrt(torch.sum((b - d) ** 2, 1, keepdim=True) + 1e-12)
        return e1, e2, e3

    o1, o2, o3 = lengths(coord_out)
    g1, g2, g3 = lengths(coord_gt)
    v1 = valid[faces[:, 0]] * valid[faces[:, 1]]
    v2 = valid[faces[:, 0]] * valid[faces[:, 2]]
    v3 = valid[faces[:, 1]] * valid[faces[:, 2]]
    return torch.cat(
        [abs_as_jax(o1 - g1) * v1, abs_as_jax(o2 - g2) * v2, abs_as_jax(o3 - g3) * v3], dim=0
    )


def face_offset_symmetric_reg(
    face_offset_full: torch.Tensor,  # (V, 3): pad_face_offset of the face offset
    face_vertex_idx: torch.Tensor,
    flip_closest_faces: torch.Tensor,  # (V, 3) vertex ids of mirror triangle
    flip_bc: torch.Tensor,  # (V, 3) barycentric weights
) -> torch.Tensor:
    """Mirror-symmetry of the face offset through the SMPL-X flip
    correspondence (reference FaceOffsetSymmetricReg, loss.py:148-167):
    x anti-symmetric, y/z symmetric, evaluated on the face vertices."""
    full = face_offset_full
    flipped = torch.einsum("vkc,vk->vc", full[flip_closest_faces.long()], flip_bc)
    loss = (
        abs_as_jax(full[:, 0] + flipped[:, 0])
        + abs_as_jax(full[:, 1] - flipped[:, 1])
        + abs_as_jax(full[:, 2] - flipped[:, 2])
    )
    return loss[face_vertex_idx.long()]


def synthetic_flip_correspondence(v_template: np.ndarray, faces: np.ndarray,
                                  chunk: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror correspondence for synthetic meshes (the real one ships as
    smplx_flip_correspondences.npz): nearest vertex to the x-mirrored
    position, as a degenerate (v, v, v) triangle with bc (1, 0, 0). The
    distances go ``chunk`` rows at a time, each row as the JAX package
    computes it, so no (V, V, 3) array is ever held."""
    v = np.asarray(v_template)
    mirrored = v * np.asarray([-1.0, 1.0, 1.0])
    nearest = np.concatenate([
        ((mirrored[i:i + chunk, None, :] - v[None, :, :]) ** 2).sum(-1).argmin(1)
        for i in range(0, v.shape[0], chunk)
    ])
    closest_faces = np.stack([nearest] * 3, axis=1).astype(np.int32)
    bc = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (v.shape[0], 1))
    return closest_faces, bc
