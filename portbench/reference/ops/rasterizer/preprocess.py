"""3DGS screen-space preprocessing: EWA projection to conics (counterpart of
exavatar_release_tpu/ops/rasterizer/preprocess.py:project_gaussians), and
the packing of gathered conic rows into tile-local quadratic coefficients
(``pack_tile_quads``).

Conventions of the CUDA rasterizer the reference uses:
* view-space cull at z <= 0.2;
* EWA Jacobian with x/z, y/z clamped to ±1.3·tan(fov);
* +0.3 pixel low-pass dilation on the 2D covariance diagonal;
* radius = ceil(3·sqrt(λ_max)), λ via eigenvalues of the dilated covariance;
* NDC→pixel: ((v + 1)·S − 1)/2 (pixel centers at integer coordinates).

Every intermediate is a flat (N,) vector in the same expression order as
the JAX package, so radii and tile rectangles match it exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...core.camera import Camera, get_fov


class ScreenGaussians(NamedTuple):
    params: torch.Tensor  # (N, 8) [conic_a, conic_b, conic_c, gx, gy, log_op, 0, 0]
    color: torch.Tensor  # (N, 4) [r, g, b, depth]
    mean2d: torch.Tensor  # (N, 2) pixel coords
    depth: torch.Tensor  # (N,) view-space z
    radius: torch.Tensor  # (N,) float screen-space radius (0 for culled)
    in_frustum: torch.Tensor  # (N,) bool
    # (N, 2) per-axis half-extent of the alpha >= 1/255 ellipse (tight AABB,
    # <= radius): binning on it drops only pairs the compositor zeroes anyway
    extent: torch.Tensor


def pack_tile_quads(params: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """Per-tile-local quadratic coefficients from gathered conic rows, plain
    PyTorch under autograd.

    params: (..., 8) rows [A, B, C, gx, gy, log_op, _, _], already gathered
    per tile; origins: broadcastable (..., 2) pixel origin of each tile.
    Returns (..., 8) rows [c0, c1, c2, c3, c4, c5, log_op, 0] such that
    q(lx, ly) = c0 + c1 lx + c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2 equals
    log_op - 0.5 mahalanobis^2 at the tile-LOCAL pixel (lx, ly). The
    compositing kernels read lane 6 only for the test q <= log_op and send no
    gradient there: the gradient of log_op reaches the rows through c0."""
    A, B, C = params[..., 0], params[..., 1], params[..., 2]
    gx = params[..., 3] - origins[..., 0]
    gy = params[..., 4] - origins[..., 1]
    log_op = params[..., 5]
    c3 = -0.5 * A
    c4 = -B
    c5 = -0.5 * C
    c1 = A * gx + B * gy
    c2 = B * gx + C * gy
    c0 = -0.5 * (A * gx * gx + 2.0 * B * gx * gy + C * gy * gy) + log_op
    return torch.stack([c0, c1, c2, c3, c4, c5, log_op, torch.zeros_like(c0)], dim=-1)


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    rgbs: torch.Tensor,
    live: torch.Tensor,
    cam: Camera,
    img_shape: Tuple[int, int],
    mean2d_offset: Optional[torch.Tensor] = None,
) -> ScreenGaussians:
    """Project N world-space Gaussians to screen space.

    means3d (N,3) world; scales (N,3) linear; quats (N,4) wxyz; opacities
    (N,1) in [0,1]; rgbs (N,3); live (N,) bool mask of real rows.
    """
    H, W = int(img_shape[0]), int(img_shape[1])
    f32 = torch.float32
    means3d = means3d.to(f32)
    R = cam.R.to(f32)
    t = cam.t.to(f32)
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    # view transform
    pvx = mx * R[0, 0] + my * R[0, 1] + mz * R[0, 2] + t[0]
    pvy = mx * R[1, 0] + my * R[1, 1] + mz * R[1, 2] + t[1]
    depth = mx * R[2, 0] + my * R[2, 1] + mz * R[2, 2] + t[2]
    in_front = depth > 0.2  # CUDA near-cull threshold

    fov = get_fov(cam.focal.to(f32), (H, W))
    tan_fovx = torch.tan(fov[0] / 2.0)
    tan_fovy = torch.tan(fov[1] / 2.0)
    # CUDA derives focal from image size + fov (principal point ignored)
    focal_x = W / (2.0 * tan_fovx)
    focal_y = H / (2.0 * tan_fovy)

    # NDC / pixel projection
    safe_z = torch.where(in_front, depth, 1.0)
    inv_z = 1.0 / safe_z
    ndc_x = pvx * inv_z * (1.0 / tan_fovx)
    ndc_y = pvy * inv_z * (1.0 / tan_fovy)
    px = ((ndc_x + 1.0) * W - 1.0) * 0.5
    py = ((ndc_y + 1.0) * H - 1.0) * 0.5
    mean2d = torch.stack([px, py], dim=1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset.to(f32)

    # EWA: 2D covariance
    q = quats.to(f32)
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    s0 = scales[:, 0].to(f32)
    s1 = scales[:, 1].to(f32)
    s2 = scales[:, 2].to(f32)
    # M = R(q) @ diag(s), row-major components
    m00 = (1 - 2 * (qy * qy + qz * qz)) * s0
    m01 = (2 * (qx * qy - qw * qz)) * s1
    m02 = (2 * (qx * qz + qw * qy)) * s2
    m10 = (2 * (qx * qy + qw * qz)) * s0
    m11 = (1 - 2 * (qx * qx + qz * qz)) * s1
    m12 = (2 * (qy * qz - qw * qx)) * s2
    m20 = (2 * (qx * qz - qw * qy)) * s0
    m21 = (2 * (qy * qz + qw * qx)) * s1
    m22 = (1 - 2 * (qx * qx + qy * qy)) * s2
    # cov3d = M @ M^T, six unique components
    cxx = m00 * m00 + m01 * m01 + m02 * m02
    cxy = m00 * m10 + m01 * m11 + m02 * m12
    cxz = m00 * m20 + m01 * m21 + m02 * m22
    cyy = m10 * m10 + m11 * m11 + m12 * m12
    cyz = m10 * m20 + m11 * m21 + m12 * m22
    czz = m20 * m20 + m21 * m21 + m22 * m22

    tx = torch.clamp(pvx * inv_z, -1.3 * tan_fovx, 1.3 * tan_fovx) * safe_z
    ty = torch.clamp(pvy * inv_z, -1.3 * tan_fovy, 1.3 * tan_fovy) * safe_z
    # J rows for x' = fx·x/z, y' = fy·y/z (third row dropped)
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * (inv_z * inv_z)
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * (inv_z * inv_z)
    # T = J @ R_view (2x3)
    t00 = j00 * R[0, 0] + j02 * R[2, 0]
    t01 = j00 * R[0, 1] + j02 * R[2, 1]
    t02 = j00 * R[0, 2] + j02 * R[2, 2]
    t10 = j11 * R[1, 0] + j12 * R[2, 0]
    t11 = j11 * R[1, 1] + j12 * R[2, 1]
    t12 = j11 * R[1, 2] + j12 * R[2, 2]
    # cov2d = T Σ T^T
    s0x = t00 * cxx + t01 * cxy + t02 * cxz
    s0y = t00 * cxy + t01 * cyy + t02 * cyz
    s0z = t00 * cxz + t01 * cyz + t02 * czz
    s1x = t10 * cxx + t11 * cxy + t12 * cxz
    s1y = t10 * cxy + t11 * cyy + t12 * cyz
    s1z = t10 * cxz + t11 * cyz + t12 * czz
    a = s0x * t00 + s0y * t01 + s0z * t02 + 0.3
    b = s0x * t10 + s0y * t11 + s0z * t12
    c = s1x * t10 + s1y * t11 + s1z * t12 + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, 1.0)
    conic_a = c / safe_det
    conic_b = -b / safe_det
    conic_c = a / safe_det

    # screen radius (CUDA: 3 sigma of the larger eigenvalue, ceil)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    visible = in_front & det_ok & live.to(torch.bool)
    radius = torch.where(visible, radius, 0.0)

    # tight per-axis extents: alpha >= 1/255 <=> M^2 <= 2(log_op + ln 255);
    # +1 px absorbs f32 boundary rounding; never looser than the circle
    log_op = torch.log(torch.clamp(opacities[:, 0].to(f32), 1e-12, 1.0))
    c_lvl = torch.clamp(2.0 * (log_op + 5.5413), min=0.0)  # ln 255 = 5.5413
    ext_x = torch.minimum(torch.sqrt(c_lvl * torch.clamp(a, min=0.0)) + 1.0, radius)
    ext_y = torch.minimum(torch.sqrt(c_lvl * torch.clamp(c, min=0.0)) + 1.0, radius)
    extent = torch.where(
        (visible & (c_lvl > 0.0))[:, None], torch.stack([ext_x, ext_y], dim=1), 0.0
    )

    # conic rows; dead rows get a finite -1e9 log-opacity (zero alpha)
    log_op_eff = torch.where(visible, log_op, -1e9)
    zeros = torch.zeros_like(log_op)
    params = torch.stack(
        [conic_a, conic_b, conic_c, mean2d[:, 0], mean2d[:, 1], log_op_eff, zeros, zeros],
        dim=1,
    )
    color = torch.cat([rgbs.to(f32), depth[:, None]], dim=1)
    return ScreenGaussians(
        params=params, color=color, mean2d=mean2d, depth=depth, radius=radius,
        in_frustum=visible, extent=extent.detach(),
    )
