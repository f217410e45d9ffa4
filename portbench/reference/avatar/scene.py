"""Scene (background) 3D Gaussians in a fixed-capacity buffer (counterpart of
exavatar_release_tpu/avatar/scene.py: state, initialisation and decoding).

The scene lives in CAPACITY rows with a ``live`` mask; dead rows render with
zero alpha. ``SceneParams`` holds the optimizable tensors, ``SceneAux`` the
state that no optimizer touches (live mask, densify statistics, camera
spread).

Densification keeps the capacity fixed, as in the JAX package: clone, split
and prune are masked gathers and scatters, and the "new row" bookkeeping
comes back as a ``reset_mask`` with which the trainer zeroes the matching
Adam moments. ``densify_and_prune`` and ``reset_opacity`` write into the
parameters in place (under ``no_grad``): the state they return holds the same
``SceneParams`` module and a new ``SceneAux``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

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


def track_stats(state: SceneState, mean2d_grad: torch.Tensor, is_vis: torch.Tensor,
                radius: torch.Tensor, img_shape=None) -> SceneState:
    """Accumulate the densification statistics: running max radius and the
    norms of the screen-space mean gradient, over rows that are visible and
    live.

    ``mean2d_grad`` (C, 2) arrives in PIXEL units; the densify threshold is
    stated for the CUDA rasterizer's NDC units (dL/d ndc = dL/d pixel * W/2),
    so with ``img_shape`` = (H, W) the gradient is scaled by (W/2, H/2)
    before its norm is taken."""
    aux = state.aux
    g2 = mean2d_grad[:, :2]
    if img_shape is not None:
        H, W = img_shape
        g2 = g2 * torch.tensor([0.5 * float(W), 0.5 * float(H)], device=g2.device)[None, :]
    g = torch.linalg.norm(g2, dim=1)
    upd = is_vis & aux.live
    return state._replace(aux=dataclasses.replace(
        aux,
        radius_max=torch.where(upd, torch.maximum(aux.radius_max, radius), aux.radius_max),
        xyz_grad_accum=aux.xyz_grad_accum + torch.where(upd, g, 0.0),
        track_cnt=aux.track_cnt + upd.float(),
    ))


def _alloc_slots(free: torch.Tensor, want: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign the i-th requested row to the i-th free slot.

    free: (C,) bool of allocatable slots; want: (M,) bool requests. Returns
    (slot_idx (M,) int32 with C for unallocated, n_dropped)."""
    C = free.shape[0]
    free_slots = torch.nonzero(free)[:, 0]  # ascending: the k-th free slot
    slot_of_rank = torch.full((C + 1,), C, dtype=torch.int64, device=free.device)
    slot_of_rank[: free_slots.shape[0]] = free_slots
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (want_rank < free_slots.shape[0])
    slots = torch.where(ok, slot_of_rank[torch.clamp(want_rank, 0, C)], C)
    return slots.to(torch.int32), torch.sum(want & ~ok).to(torch.int32)


def _write_rows(params: SceneParams, src_idx: torch.Tensor, dst_slots: torch.Tensor,
                mean_new: Optional[torch.Tensor] = None,
                scale_new: Optional[torch.Tensor] = None) -> None:
    """Copy rows src_idx -> dst_slots in place (slot C = dropped), optionally
    overriding mean/scale (the split case). Every source row is read before
    any row is written."""
    C = params.mean.shape[0]
    keep = dst_slots.long() < C
    dst = dst_slots.long()[keep]
    src = src_idx.long()[keep]
    override = {"mean": mean_new, "scale": scale_new}
    with torch.no_grad():
        new = {name: (p[src] if override.get(name) is None else override[name][keep])
               for name, p in params.named_parameters()}
        for name, p in params.named_parameters():
            p[dst] = new[name]


class DensifyResult(NamedTuple):
    state: SceneState
    reset_mask: torch.Tensor  # (C,) rows whose Adam moments must be zeroed
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # densify requests dropped for lack of capacity


def densify_and_prune(state: SceneState, cfg: AvatarConfig, use_screen_size_prune: bool,
                      screen_size_max: float = 20.0, split_factor: int = 2,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> DensifyResult:
    """Clone/split/prune pass at fixed capacity.

    Points whose mean screen-space gradient is >= ``densify_grad_thr`` are
    cloned (if small: max scale <= dense_percent_thr * cam radius) or split
    into ``split_factor`` resampled points at scale / (0.8 split_factor) (if
    large; the original dies). Then prune: opacity < opacity_min, or (when
    enabled) screen radius > ``screen_size_max`` or world scale > 0.1 * cam
    radius. The statistics restart from zero.

    The children's noise ``eps`` (split_factor, C, 3) is standard normal,
    drawn from ``generator`` (on the state's device) unless given."""
    p, aux = state.params, state.aux
    C, dev = p.mean.shape[0], p.mean.device
    with torch.no_grad():
        grad = torch.where(aux.track_cnt > 0,
                           aux.xyz_grad_accum / torch.clamp(aux.track_cnt, min=1.0), 0.0)
        sigma = torch.exp(p.scale)  # (C, 3)
        maxscale = torch.amax(sigma, dim=1)
        thr_scale = cfg.dense_percent_thr * aux.cam_dist_radius

        hot = aux.live & (grad >= cfg.densify_grad_thr)
        clone_mask = hot & (maxscale <= thr_scale)
        split_mask = hot & (maxscale > thr_scale)

        # prune originals: low opacity / too big / split sources
        do_prune = aux.live & (torch.sigmoid(p.opacity[:, 0]) < cfg.opacity_min)
        if use_screen_size_prune:
            big_vs = aux.radius_max > screen_size_max
            big_ws = maxscale > 0.1 * aux.cam_dist_radius
            do_prune = do_prune | (aux.live & (big_vs | big_ws))
        live = aux.live & ~do_prune & ~split_mask

        # requests laid out as [clone copies | split children x split_factor]
        idx = torch.arange(C, device=dev)
        want = torch.cat([clone_mask] + [split_mask] * split_factor)
        src = torch.cat([idx] * (1 + split_factor))
        slots, n_dropped = _alloc_slots(~live, want)

        # split children: resample positions from the Gaussian, shrink scale
        R = rotation_6d_to_matrix(p.rotation)  # (C, 3, 3)
        if eps is None:
            eps = torch.randn(split_factor, C, 3, generator=generator, device=dev)
        child_means = torch.einsum("cij,kcj->kci", R, eps * sigma[None]) + p.mean[None]
        child_scale = torch.log(sigma / (0.8 * split_factor))
        mean_rows = torch.cat([p.mean] + [child_means[k] for k in range(split_factor)])
        scale_rows = torch.cat([p.scale] + [child_scale] * split_factor)

        _write_rows(p, src, slots, mean_rows, scale_rows)
        written = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        written[slots.long()] = want
        written = written[:C]
        live = live | written

    z = lambda: torch.zeros(C, device=dev)
    new_aux = dataclasses.replace(aux, live=live, radius_max=z(), xyz_grad_accum=z(),
                                  track_cnt=z())
    count = lambda m: torch.sum(m).to(torch.int32)
    return DensifyResult(
        state=SceneState(p, new_aux),
        # moments of new rows and freed rows start from zero
        reset_mask=written | do_prune | split_mask,
        n_cloned=count(clone_mask), n_split=count(split_mask), n_pruned=count(do_prune),
        n_dropped=n_dropped,
    )


def reset_opacity(state: SceneState) -> Tuple[SceneState, torch.Tensor]:
    """Clamp opacity to <= 0.01, in place. Returns the state and the reset
    mask for the opacity's Adam moments (every row)."""
    p = state.params
    with torch.no_grad():
        op = torch.clamp(torch.sigmoid(p.opacity), max=0.01)
        p.opacity.copy_(torch.log(op / (1.0 - op)))
    return state, torch.ones(p.opacity.shape[0], dtype=torch.bool, device=p.opacity.device)
