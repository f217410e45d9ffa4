"""Render-ready Gaussians (counterpart of
exavatar_release_tpu/avatar/gaussians.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianAssets(NamedTuple):
    mean_3d: torch.Tensor  # (N, 3) world
    opacity: torch.Tensor  # (N, 1) in [0, 1]
    scale: torch.Tensor  # (N, 3) linear
    rotation: torch.Tensor  # (N, 4) wxyz unit quaternions
    rgb: torch.Tensor  # (N, 3)
    live: torch.Tensor  # (N,) bool


def concat_assets(a: GaussianAssets, b: GaussianAssets) -> GaussianAssets:
    """Scene + human composition: rows of ``a`` first."""
    return GaussianAssets(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def detach_assets(a: GaussianAssets) -> GaussianAssets:
    return GaussianAssets(*(x.detach() for x in a))
