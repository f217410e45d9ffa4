"""Geometry utilities: covariances, normals, Procrustes alignment
(counterpart of exavatar_release_tpu/core/geometry.py).

* covariance from scale+rotation (reference avatar/common/utils/transforms.py:72-80)
* per-vertex normals (pytorch3d Meshes.verts_normals_packed equivalent,
  used at reference avatar/common/nets/module.py:502)
* Umeyama similarity alignment (pytorch3d corresponding_points_alignment,
  used at reference fitting/data/Custom/Custom.py:155)
"""
from __future__ import annotations

from typing import Tuple

import torch

from .rotations import quaternion_to_matrix


def covariance_from_scale_quat(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """3D covariance M = R S S^T R^T. scale: (..., 3); quat: (..., 4) wxyz."""
    RS = quaternion_to_matrix(quat) * scale[..., None, :]  # R @ diag(scale)
    return torch.matmul(RS, RS.transpose(-1, -2))


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals, normalized.

    verts: (V, 3) float; faces: (F, 3) int. Matches pytorch3d's
    verts_normals_packed (sum of un-normalized face normals, then normalize).
    """
    faces = faces.long()
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # area-weighted
    normals = torch.zeros_like(verts)
    for c in range(3):
        normals = normals.index_add(0, faces[:, c], fn)
    # cancelled/unreferenced vertices have zero normals; keep them zero and
    # keep norm(0) out of the backward pass
    degen = torch.sum(normals * normals, dim=-1, keepdim=True) < 1e-24
    safe = torch.where(degen, torch.tensor([0.0, 0.0, 1.0], device=verts.device), normals)
    return torch.where(degen, 0.0, safe / torch.linalg.norm(safe, dim=-1, keepdim=True))


def umeyama(src: torch.Tensor, dst: torch.Tensor, estimate_scale: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity transform (R, t, s) minimizing ||s * src @ R^T + t - dst||².

    src, dst: (N, 3), on any device. Returns R (3,3), t (3,), s (a 0-d
    tensor), such that aligned = s * src @ R.T + t.
    """
    n = src.shape[0]
    mu_src, mu_dst = src.mean(dim=0), dst.mean(dim=0)
    xs, xd = src - mu_src, dst - mu_dst
    cov = (xd.T @ xs) / n
    U, D, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=src.dtype, device=src.device)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S[2, 2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ S @ Vt
    if estimate_scale:
        var_src = (xs ** 2).sum() / n
        s = torch.trace(torch.diag(D) @ S) / torch.clamp(var_src, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_dst - s * (R @ mu_src)
    return R, t, s


def transform_points_homogeneous(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., 3) points."""
    p1 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", T, p1)[..., :3]
