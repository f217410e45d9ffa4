"""Bilinear grid sampling (counterpart of
exavatar_release_tpu/ops/grid_sample.py).

torch's ``F.grid_sample`` with its defaults (bilinear, align_corners=False,
zero padding) is the semantics the JAX gather + lerp reimplements. The 2-D
sampler of textures and images follows the JAX package's float32 arithmetic
as well; the triplane sampler calls ``F.grid_sample``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (C, H, W) at normalized ``coords`` (N, 2) in [-1, 1];
    coords[:, 0] indexes W. Out-of-range taps read zeros. Returns (N, C).

    The taps are blended as the JAX package blends them, a lerp along x and
    then along y: equal taps give their value back exactly. ``F.grid_sample``
    sums the four taps times their weights, which gives 1 - 2^-24 from four
    texels of 1 at some points, and the face loss tests the texture mask's
    channel for == 1."""
    C, H, W = feat.shape
    x = (coords[:, 0] + 1.0) * (W * 0.5) - 0.5
    y = (coords[:, 1] + 1.0) * (H * 0.5) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[None], (y - y0)[None]
    x0i, y0i = x0.long(), y0.long()

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = feat[:, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]  # (C, N)
        return torch.where(inside[None, :], v, 0.0)

    top = tap(x0i, y0i) * (1.0 - tx) + tap(x0i + 1, y0i) * tx
    bot = tap(x0i, y0i + 1) * (1.0 - tx) + tap(x0i + 1, y0i + 1) * tx
    return (top * (1.0 - ty) + bot * ty).T


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
