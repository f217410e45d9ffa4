"""Render-ready Gaussians (counterpart of
exavatar_release_tpu/avatar/gaussians.py:GaussianAssets)."""
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
