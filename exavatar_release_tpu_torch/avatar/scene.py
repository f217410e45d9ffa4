"""Scene (background) 3D Gaussians in a fixed-capacity buffer (counterpart of
exavatar_release_tpu/avatar/scene.py: state, initialisation and decoding).

The scene lives in CAPACITY rows with a ``live`` mask; dead rows render with
zero alpha. ``SceneParams`` holds the optimizable tensors, ``SceneAux`` the
state that no optimizer touches (live mask, densify statistics, camera
spread). Densification (``track_stats``, ``densify_and_prune``,
``reset_opacity``) waits for the training-loop slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..core.rotations import matrix_to_quaternion, matrix_to_rotation_6d, rotation_6d_to_matrix
from ..core.sh import eval_sh_dynamic, rgb_to_sh
from ..ops.knn import mean_knn_dist_sq
from .config import AvatarConfig
from .gaussians import GaussianAssets


class SceneParams(nn.Module):
    """Optimizable per-Gaussian parameters (capacity C rows)."""

    def __init__(self, mean, scale, rotation, feature_dc, feature_rest, opacity):
        super().__init__()
        self.mean = nn.Parameter(mean)  # (C, 3)
        self.scale = nn.Parameter(scale)  # (C, 3) log-scale
        self.rotation = nn.Parameter(rotation)  # (C, 6) 6D rotation
        self.feature_dc = nn.Parameter(feature_dc)  # (C, 1, 3) SH band 0
        self.feature_rest = nn.Parameter(feature_rest)  # (C, (max_deg+1)^2-1, 3)
        self.opacity = nn.Parameter(opacity)  # (C, 1) logit


@dataclasses.dataclass(frozen=True)
class SceneAux:
    """Non-optimized scene state."""

    live: torch.Tensor  # (C,) bool
    radius_max: torch.Tensor  # (C,) max screen radius seen (prune signal)
    xyz_grad_accum: torch.Tensor  # (C,) accumulated |d mean2d| (densify signal)
    track_cnt: torch.Tensor  # (C,) number of accumulations
    active_sh_degree: torch.Tensor  # () float
    cam_dist_trans: torch.Tensor  # (3,) scene camera centroid
    cam_dist_radius: torch.Tensor  # () scene camera spread radius


class SceneState(NamedTuple):
    params: SceneParams
    aux: SceneAux

    @property
    def capacity(self) -> int:
        return self.params.mean.shape[0]

    @property
    def num_live(self) -> torch.Tensor:
        return torch.sum(self.aux.live.to(torch.int32))


def _zero_aux(live: torch.Tensor, cam_dist_trans: torch.Tensor,
              cam_dist_radius: torch.Tensor) -> SceneAux:
    C, dev = live.shape[0], live.device
    z = lambda: torch.zeros(C, device=dev)
    return SceneAux(live=live, radius_max=z(), xyz_grad_accum=z(), track_cnt=z(),
                    active_sh_degree=torch.zeros((), device=dev),
                    cam_dist_trans=cam_dist_trans, cam_dist_radius=cam_dist_radius)


def init_from_point_cloud(xyz: torch.Tensor, rgb: torch.Tensor, cam_dist_trans: torch.Tensor,
                          cam_dist_radius, capacity: int,
                          max_sh_degree: int = 3) -> SceneState:
    """3DGS initialisation from a point cloud, on ``xyz``'s device: log-scale
    from the mean distance to the 3 nearest other points, identity rotation,
    SH DC from RGB, opacity logit of 0.1."""
    n, dev = xyz.shape[0], xyz.device
    if n > capacity:
        raise ValueError(f"point cloud of {n} exceeds capacity {capacity}")
    C = capacity
    xyz = xyz.float()
    scale = torch.log(torch.sqrt(mean_knn_dist_sq(xyz, k=4)))[:, None].repeat(1, 3)
    bands = (max_sh_degree + 1) ** 2

    def pad(x):
        return torch.cat([x, torch.zeros((C - n,) + x.shape[1:], device=dev)], dim=0)

    # dead rows hold identity 6D rotations too: a zero row is a degenerate
    # Gram-Schmidt input whose backward would emit NaNs
    rot6d = matrix_to_rotation_6d(torch.eye(3, device=dev)).reshape(1, 6).repeat(C, 1)
    params = SceneParams(
        mean=pad(xyz),
        scale=pad(scale),
        rotation=rot6d,
        feature_dc=pad(rgb_to_sh(rgb.float())[:, None, :]),
        feature_rest=torch.zeros(C, bands - 1, 3, device=dev),
        opacity=pad(torch.full((n, 1), math.log(0.1 / 0.9), device=dev)),
    )
    aux = _zero_aux(torch.arange(C, device=dev) < n, cam_dist_trans.float().to(dev),
                    torch.as_tensor(cam_dist_radius, dtype=torch.float32, device=dev))
    return SceneState(params, aux)


def init_empty(capacity: int, max_sh_degree: int = 3, device="cuda") -> SceneState:
    """Zero state of a given capacity (the target a checkpoint restores into)."""
    C = capacity
    bands = (max_sh_degree + 1) ** 2
    z = lambda *s: torch.zeros(*s, device=device)
    params = SceneParams(mean=z(C, 3), scale=z(C, 3), rotation=z(C, 6), feature_dc=z(C, 1, 3),
                         feature_rest=z(C, bands - 1, 3), opacity=z(C, 1))
    aux = _zero_aux(torch.zeros(C, dtype=torch.bool, device=device), z(3), z(()))
    return SceneState(params, aux)


def scene_assets(state: SceneState, cam_R: torch.Tensor, cam_t: torch.Tensor) -> GaussianAssets:
    """Decode parameters to render-ready assets with view-dependent SH color."""
    p = state.params
    mean_3d = p.mean
    opacity = torch.sigmoid(p.opacity)
    scale = torch.exp(p.scale)
    rotation = matrix_to_quaternion(rotation_6d_to_matrix(p.rotation))
    sh = torch.cat([p.feature_dc, p.feature_rest], dim=1)  # (C, B, 3)

    cam_pos = -cam_R.T @ cam_t
    diff = mean_3d - cam_pos[None, :]
    # a Gaussian exactly at the camera center (a dead zero row) must not put
    # a NaN into the backward pass of the norm
    degen = torch.sum(diff * diff, dim=1, keepdim=True) < 1e-20
    safe = torch.where(degen, torch.tensor([0.0, 0.0, 1.0], device=diff.device), diff)
    view_dir = safe / torch.linalg.norm(safe, dim=1, keepdim=True)
    rgb = eval_sh_dynamic(state.aux.active_sh_degree, sh.transpose(1, 2), view_dir)
    rgb = torch.clamp(rgb + 0.5, min=0.0)
    return GaussianAssets(mean_3d=mean_3d, opacity=opacity, scale=scale, rotation=rotation,
                          rgb=rgb, live=state.aux.live)


def set_sh_degree(state: SceneState, itr: int, cfg: AvatarConfig) -> SceneState:
    deg = min(itr // cfg.increase_sh_degree_interval, cfg.max_sh_degree)
    aux = dataclasses.replace(
        state.aux, active_sh_degree=torch.tensor(float(deg), device=state.aux.live.device))
    return state._replace(aux=aux)
