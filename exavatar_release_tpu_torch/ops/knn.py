"""Brute-force K-nearest-neighbour search (counterpart of
exavatar_release_tpu/ops/knn.py).

Distances are ``||q||² - 2 q·rᵀ + ||r||²`` in query chunks, the same
expanded form as the JAX package, so that ties resolve the same way: a
subdivision midpoint is exactly equidistant from two low-resolution
vertices, and the rounding of this expression decides which one wins.
Chunking bounds the (chunk, R) distance matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KNNResult(NamedTuple):
    dists: torch.Tensor  # (Q, K) squared distances, ascending
    idx: torch.Tensor  # (Q, K) int64 indices into the reference set


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, chunk: int = 4096) -> KNNResult:
    """K nearest neighbours of each query point among reference points.

    query: (Q, D); ref: (R, D). For k == 1 the index is the first minimum.
    """
    k = min(k, ref.shape[0])
    ref = ref.float()
    query = query.float()
    r_sq = torch.sum(ref * ref, dim=1)
    dists, idxs = [], []
    for q in torch.split(query, chunk):
        q_sq = torch.sum(q * q, dim=1, keepdim=True)
        d2 = torch.clamp(q_sq - 2.0 * torch.matmul(q, ref.T) + r_sq[None, :], min=0.0)
        if k == 1:
            idx = torch.argmin(d2, dim=1, keepdim=True)
            dists.append(torch.gather(d2, 1, idx))
        else:
            d, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
            dists.append(d)
        idxs.append(idx)
    return KNNResult(dists=torch.cat(dists), idx=torch.cat(idxs))


def mean_knn_dist_sq(points: torch.Tensor, k: int = 4, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the k-1 nearest *other* points, clamped to
    >= 1e-7: the 3DGS scale-init statistic. The nearest match (the point
    itself, at distance 0) is dropped."""
    d = knn(points, points, k, chunk=chunk).dists[:, 1:]
    return torch.clamp(torch.mean(d, dim=1), min=1e-7)
