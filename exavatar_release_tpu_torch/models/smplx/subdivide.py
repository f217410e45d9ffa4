"""Midpoint mesh subdivision with feature interpolation (counterpart of
exavatar_release_tpu/models/smplx/subdivide.py).

Low-resolution vertices come FIRST in the upsampled vertex order; appended
vertices are edge midpoints. Topology is precomputed once in numpy; the
runtime ``apply`` is a gather + mean on tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SubdivisionOp:
    """One level of midpoint subdivision.

    edge_pairs: (E, 2) endpoint vertex ids of each unique edge, sorted so
    that new vertex V_in + e is the midpoint of edge_pairs[e].
    faces_out: (4*F, 3) subdivided triangles.
    """

    edge_pairs: torch.Tensor  # (E, 2) int64
    faces_out: np.ndarray  # (4F, 3) int32
    num_verts_in: int
    num_verts_out: int

    def apply(self, feats: torch.Tensor) -> torch.Tensor:
        """(V_in, C) -> (V_out, C): keep old rows, append edge midpoints."""
        mid = 0.5 * (feats[self.edge_pairs[:, 0]] + feats[self.edge_pairs[:, 1]])
        return torch.cat([feats, mid], dim=0)


def midpoint_subdivide(faces: np.ndarray, num_verts: int, device="cuda") -> SubdivisionOp:
    """Precompute one subdivision level; new vertices follow the
    lexicographic order of the unique edges."""
    faces = np.asarray(faces, dtype=np.int64)
    all_edges = np.sort(
        np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0),
        axis=1,
    )
    uniq, inv = np.unique(all_edges, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    F = faces.shape[0]
    m01 = num_verts + inv[0:F]
    m12 = num_verts + inv[F: 2 * F]
    m20 = num_verts + inv[2 * F: 3 * F]
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    faces_out = np.concatenate(
        [
            np.stack([v0, m01, m20], axis=1),
            np.stack([v1, m12, m01], axis=1),
            np.stack([v2, m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    ).astype(np.int32)
    return SubdivisionOp(
        edge_pairs=torch.from_numpy(uniq).to(device),
        faces_out=faces_out,
        num_verts_in=int(num_verts),
        num_verts_out=int(num_verts + uniq.shape[0]),
    )


def build_subdivision(
    faces: np.ndarray, num_verts: int, levels: int = 2, device="cuda"
) -> Tuple[List[SubdivisionOp], np.ndarray, int]:
    """Stack of subdivision ops. Returns (ops, final faces (4^levels * F, 3)
    numpy int32, final vertex count)."""
    ops: List[SubdivisionOp] = []
    cur_faces = np.asarray(faces)
    cur_verts = int(num_verts)
    for _ in range(levels):
        op = midpoint_subdivide(cur_faces, cur_verts, device)
        ops.append(op)
        cur_faces = op.faces_out
        cur_verts = op.num_verts_out
    return ops, cur_faces.astype(np.int32), cur_verts


def upsample_features(ops: List[SubdivisionOp], feats: torch.Tensor) -> torch.Tensor:
    """Apply all subdivision levels to per-vertex features (V, C) -> (V_hr, C)."""
    for op in ops:
        feats = op.apply(feats)
    return feats
