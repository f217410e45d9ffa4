"""Pinhole cameras (counterpart of exavatar_release_tpu/core/camera.py).

* world->camera: x_cam = R @ x_world + t;
* +z forward, +x right, +y down (OpenCV-style, as the reference datasets).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Camera(NamedTuple):
    """Pinhole camera; every field is a float32 tensor on one device."""

    R: torch.Tensor  # (3, 3) world->cam rotation
    t: torch.Tensor  # (3,)  world->cam translation
    focal: torch.Tensor  # (2,) fx, fy in pixels
    princpt: torch.Tensor  # (2,) cx, cy in pixels


def get_fov(focal: torch.Tensor, img_shape: Tuple[int, int]) -> torch.Tensor:
    """(fov_x, fov_y) radians. img_shape is (H, W)."""
    fov_x = 2.0 * torch.atan(img_shape[1] / (2.0 * focal[0]))
    fov_y = 2.0 * torch.atan(img_shape[0] / (2.0 * focal[1]))
    return torch.stack([fov_x, fov_y])


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World->cam (R, t) for a camera at ``eye`` looking at ``target``."""
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=0)
    return R, -R @ eye
