"""Pinhole cameras, view/projection matrices and coordinate transforms
(counterpart of exavatar_release_tpu/core/camera.py).

* world->camera: x_cam = R @ x_world + t;
* +z forward, +x right, +y down (OpenCV-style, as the reference datasets);
* view matrix V = [[R, t], [0, 1]]; an OpenGL-style perspective from the
  FoV with z_near = 0.01, z_far = 100, z_sign = +1; full projection P @ V.
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


def world_to_cam(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points -> camera frame."""
    return points @ R.T + t[None, :]


def cam_to_world(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (points - t[None, :]) @ R


def cam_to_pixel(cam_points: torch.Tensor, focal, princpt) -> torch.Tensor:
    """Perspective projection to pixels, keeping z."""
    z = cam_points[..., 2]
    x = cam_points[..., 0] / z * focal[0] + princpt[0]
    y = cam_points[..., 1] / z * focal[1] + princpt[1]
    return torch.stack([x, y, z], dim=-1)


def pixel_to_cam(pix_points: torch.Tensor, focal, princpt) -> torch.Tensor:
    z = pix_points[..., 2]
    x = (pix_points[..., 0] - princpt[0]) / focal[0] * z
    y = (pix_points[..., 1] - princpt[1]) / focal[1] * z
    return torch.stack([x, y, z], dim=-1)


def get_fov(focal: torch.Tensor, img_shape: Tuple[int, int]) -> torch.Tensor:
    """(fov_x, fov_y) radians. img_shape is (H, W)."""
    fov_x = 2.0 * torch.atan(img_shape[1] / (2.0 * focal[0]))
    fov_y = 2.0 * torch.atan(img_shape[0] / (2.0 * focal[1]))
    return torch.stack([fov_x, fov_y])


def get_view_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera matrix [[R, t], [0, 1]]."""
    top = torch.cat([R, t.reshape(3, 1)], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom], dim=0)


def get_proj_matrix(focal: torch.Tensor, img_shape: Tuple[int, int], z_near: float = 0.01,
                    z_far: float = 100.0) -> torch.Tensor:
    """OpenGL-style perspective projection of the symmetric frustum from the
    FoV (the off-center terms are zero by construction)."""
    fov = get_fov(focal, img_shape)
    tan_half_x = torch.tan(fov[0] / 2.0)
    tan_half_y = torch.tan(fov[1] / 2.0)
    z_sign = 1.0
    P = torch.zeros(4, 4, dtype=torch.promote_types(tan_half_x.dtype, torch.float32),
                    device=focal.device)
    P[0, 0] = 1.0 / tan_half_x
    P[1, 1] = 1.0 / tan_half_y
    P[3, 2] = z_sign
    P[2, 2] = z_sign * z_far / (z_far - z_near)
    P[2, 3] = -(z_far * z_near) / (z_far - z_near)
    return P


def full_projection(cam: Camera, img_shape: Tuple[int, int]) -> torch.Tensor:
    """P @ V: maps world homogeneous points to clip space."""
    V = get_view_matrix(cam.R, cam.t)
    P = get_proj_matrix(cam.focal, img_shape)
    return P @ V


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
