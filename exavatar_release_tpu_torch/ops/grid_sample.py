"""Bilinear grid sampling (counterpart of
exavatar_release_tpu/ops/grid_sample.py).

torch's ``F.grid_sample`` with its defaults (bilinear, align_corners=False,
zero padding) is the semantics the JAX gather + lerp reimplements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (C, H, W) at normalized ``coords`` (N, 2) in [-1, 1];
    coords[:, 0] indexes W. Out-of-range taps read zeros. Returns (N, C)."""
    out = F.grid_sample(
        feat[None], coords[None, None], mode="bilinear", padding_mode="zeros",
        align_corners=False,
    )  # (1, C, 1, N)
    return out[0, :, 0, :].T


def triplane_sample(triplane: torch.Tensor, xyz: torch.Tensor,
                    half_extent: torch.Tensor) -> torch.Tensor:
    """Sample a 3-plane feature volume at 3D points.

    triplane: (3, C, H, W), planes ordered (xy, xz, yz); xyz: (N, 3) centered
    coordinates; half_extent: (3,) normalization half-sizes.
    Returns (N, 3C) concatenated plane features.
    """
    n = xyz / half_extent[None, :]
    grid = torch.stack([n[:, [0, 1]], n[:, [0, 2]], n[:, [1, 2]]], dim=0)  # (3, N, 2)
    out = F.grid_sample(
        triplane, grid[:, None], mode="bilinear", padding_mode="zeros",
        align_corners=False,
    )  # (3, C, 1, N)
    return out[:, :, 0, :].permute(2, 0, 1).reshape(xyz.shape[0], -1)
