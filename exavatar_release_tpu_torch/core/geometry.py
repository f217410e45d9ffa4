"""Per-vertex normals (counterpart of exavatar_release_tpu/core/geometry.py)."""
from __future__ import annotations

import torch


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
