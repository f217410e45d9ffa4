"""Avatar losses as masked-mean functions (counterpart of
exavatar_release_tpu/avatar/losses.py).

Every loss map stays full-size: the human bbox is a multiplicative mask with
a masked mean (``ops.image_metrics.bbox_mask``), and the part-vertex
selections (hands, face, arms) are index lists resolved when the model is
built, as in the JAX package, so both compute the same numbers.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.geometry import vertex_normals
from ..models.smplx.structs import SMPLX_JOINT_NAMES
from ..ops.image_metrics import masked_mean, ssim_map
from ..ops.lpips import LPIPSParams, lpips_distance
from ..utils.profiling import spanned

# --------------------------------------------------------------------------
# image-space losses
# --------------------------------------------------------------------------


def rgb_l1(img_out: torch.Tensor, img_target: torch.Tensor,
           region_mask: Optional[torch.Tensor] = None, fg_mask: Optional[torch.Tensor] = None,
           bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 loss on (3, H, W) images: optional background composition of the
    target (fg_mask + bg), then the mean over ``region_mask`` (the bbox) or
    the full image."""
    if fg_mask is not None and bg is not None:
        img_target = img_target * fg_mask + (1.0 - fg_mask) * bg[:, None, None]
    return masked_mean(torch.abs(img_out - img_target), region_mask)


def rgb_l1_weighted_full(img_out: torch.Tensor, img_target: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """|err| * weight averaged over the FULL image: the scene-loss form."""
    return torch.mean(torch.abs(img_out - img_target) * weight)


def ssim_loss(img_out: torch.Tensor, img_target: torch.Tensor,
              region_mask: Optional[torch.Tensor] = None,
              mul_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 - SSIM) mean: ``mul_mask`` multiplies the inputs before windowing
    (scene form, full-image mean); ``region_mask`` is the bbox masked mean
    (human form)."""
    s = ssim_map(img_out, img_target, mask=mul_mask)
    if mul_mask is not None:
        return torch.mean(1.0 - s)
    return masked_mean(1.0 - s, region_mask)


@spanned("loss.lpips")
def lpips_loss(lpips_params: LPIPSParams, img_out: torch.Tensor, img_target: torch.Tensor,
               region_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LPIPS on [0, 1] images."""
    return lpips_distance(lpips_params, img_out * 2.0 - 1.0, img_target * 2.0 - 1.0,
                          mask=region_mask)


# --------------------------------------------------------------------------
# vertex regularizers (static neighbor / part tables)
# --------------------------------------------------------------------------


def build_laplacian_neighbors(faces: np.ndarray, vertex_num: int,
                              neighbor_max: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacency table: up to 10 neighbors per vertex in the iteration order
    of a Python set, weight -1/num_neighbors, self-padded."""
    adj = [set() for _ in range(vertex_num)]
    for tri in np.asarray(faces):
        a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
        adj[a] |= {b, c}
        adj[b] |= {a, c}
        adj[c] |= {a, b}
    idxs = np.tile(np.arange(vertex_num)[:, None], (1, neighbor_max))
    weights = np.zeros((vertex_num, neighbor_max), np.float32)
    for v in range(vertex_num):
        nb = list(adj[v])[:neighbor_max]
        n = len(nb)
        if n:
            idxs[v, :n] = np.asarray(nb)
            weights[v, :n] = -1.0 / n
    return idxs.astype(np.int32), weights


def laplacian(x: torch.Tensor, neighbor_idxs: torch.Tensor,
              neighbor_weights: torch.Tensor) -> torch.Tensor:
    """x + sum_j w_j x_j per vertex. x: (V, C). The neighbor gather goes
    through ``index_select``, whose backward adds atomically where that of
    ``x[idx]`` sorts the indices first."""
    V, nb = neighbor_idxs.shape
    xn = torch.index_select(x, 0, neighbor_idxs.reshape(-1).long()).reshape(V, nb, -1)
    return x + torch.sum(xn * neighbor_weights[..., None], dim=1)


def laplacian_multi(xs: Sequence[torch.Tensor], neighbor_idxs: torch.Tensor,
                    neighbor_weights: torch.Tensor) -> List[torch.Tensor]:
    """``laplacian`` of several (V, C_i) inputs through one neighbor gather
    (and one scatter in the backward); exact per input."""
    lap = laplacian(torch.cat(list(xs), dim=1), neighbor_idxs, neighbor_weights)
    return list(torch.split(lap, [x.shape[1] for x in xs], dim=1))


def laplacian_reg(x: torch.Tensor, target: Optional[torch.Tensor], neighbor_idxs: torch.Tensor,
                  neighbor_weights: torch.Tensor,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared (relative) Laplacian, weighted mean."""
    lap = laplacian(x, neighbor_idxs, neighbor_weights)
    if target is not None:
        lap = lap - laplacian(target, neighbor_idxs, neighbor_weights)
    sq = lap ** 2
    if weight is not None:
        sq = sq * weight[:, None]
    return torch.mean(sq)


def symmetric_joint_pairs() -> Tuple[np.ndarray, np.ndarray]:
    """(right_idx, left_idx) joint pairs."""
    right, left = [], []
    for j, name in enumerate(SMPLX_JOINT_NAMES):
        if name.startswith("R_"):
            right.append(j)
            left.append(SMPLX_JOINT_NAMES.index("L_" + name[2:]))
    return np.asarray(right, np.int32), np.asarray(left, np.int32)


def abs_as_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s derivative at 0, which is +1 (``torch.abs``'s is
    0): an L1 term at exactly zero, such as offsets that start at zero, then
    moves Adam as it does in JAX."""
    return torch.where(x >= 0, x, -x)


def joint_offset_symmetric_reg(joint_offset: torch.Tensor, right_idx: torch.Tensor,
                               left_idx: torch.Tensor) -> torch.Tensor:
    """Mirror symmetry of joint offsets: x anti-symmetric, y/z symmetric."""
    r = joint_offset[right_idx.long()]
    l = joint_offset[left_idx.long()]
    loss = (abs_as_jax(r[:, 0] + l[:, 0]) + abs_as_jax(r[:, 1] - l[:, 1])
            + abs_as_jax(r[:, 2] - l[:, 2]))
    return torch.mean(loss)


def hand_mean_reg(mesh_neutral_pose: torch.Tensor, offset: torch.Tensor, faces_hr: torch.Tensor,
                  is_hand: torch.Tensor) -> torch.Tensor:
    """Penalize offsets pointing OUT of the hand surface:
    clamp(normal . normalize(offset), 0), mean over hand vertices."""
    normal = vertex_normals(mesh_neutral_pose, faces_hr).detach()
    # hand offsets are exactly zero early in training (the regressed branch
    # is masked out there) and norm(0) would put a NaN into the backward
    degen = torch.sum(offset * offset, dim=1, keepdim=True) < 1e-24
    safe = torch.where(degen, torch.tensor([0.0, 0.0, 1.0], device=offset.device), offset)
    off_n = torch.where(degen, 0.0, safe / torch.linalg.norm(safe, dim=1, keepdim=True))
    loss = torch.clamp(torch.sum(normal * off_n, dim=1), min=0.0)
    m = is_hand.float()
    return torch.sum(loss * m) / torch.clamp(torch.sum(m), min=1.0)


def hand_rgb_reg(rgb: torch.Tensor, is_rhand: torch.Tensor,
                 is_lhand: torch.Tensor) -> torch.Tensor:
    """Tie hand colors to the (detached) per-hand mean color."""
    def one(mask):
        m = mask.float()[:, None]
        mean = (torch.sum(rgb * m, dim=0) / torch.clamp(torch.sum(m), min=1.0)).detach()
        sq = (rgb - mean[None, :]) ** 2
        return torch.sum(sq * m) / torch.clamp(torch.sum(m) * rgb.shape[1], min=1.0)

    return one(is_rhand) + one(is_lhand)


def arm_rgb_reg(mesh_neutral_pose: torch.Tensor, upper_idx: torch.Tensor,
                lower_idx: torch.Tensor, rgb: torch.Tensor, dist_x_thr: float = 0.01,
                top_k: int = 50) -> torch.Tensor:
    """Tie lower-arm colors to nearby upper-arm colors: for each lower-arm
    vertex the 50 upper-arm vertices closest in 3D among those within 1 cm
    along x, their (detached) colors averaged, L2 to the lower-arm color.
    The top-k is exact (the JAX package's is approximate on a TPU and exact
    on the CPU) and, like it, keeps the lower index among equal distances:
    rows with fewer than 50 gated candidates fill up from the ungated ones,
    which all tie."""
    upper_idx, lower_idx = upper_idx.long(), lower_idx.long()
    up = mesh_neutral_pose[upper_idx]  # (n_up, 3)
    low = mesh_neutral_pose[lower_idx]  # (n_low, 3)
    with torch.no_grad():
        gate = torch.abs(low[:, None, 0] - up[None, :, 0]) < dist_x_thr
        # rank by squared distance: the same order without the sqrt
        # one coordinate at a time: no (n_low, n_up, 3) temporary
        dist = sum((low[:, None, c] - up[None, :, c]) ** 2 for c in range(3))
        dist = torch.where(gate, dist, 9999.0)
        k = min(top_k, up.shape[0])
        nn_idx = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    up_rgb = rgb[upper_idx].detach()  # (n_up, 3)
    target = torch.mean(up_rgb[nn_idx], dim=1)  # (n_low, 3)
    return torch.mean((rgb[lower_idx] - target) ** 2)
