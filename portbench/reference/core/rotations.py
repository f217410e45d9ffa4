"""Rotation representation conversions (counterpart of
exavatar_release_tpu/core/rotations.py).

Conventions, as ``pytorch3d.transforms``:

* quaternions are (w, x, y, z), unit norm;
* the 6D representation is the first two ROWS of the rotation matrix,
  flattened (Zhou et al., CVPR 2019), orthonormalised on decode;
* axis-angle vectors encode angle = ||v|| about axis v/||v||.

All functions broadcast over leading batch dimensions. Near angle 0 they take
Taylor branches through the double-where pattern so autograd stays NaN-free.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. axis_angle: (..., 3) -> (..., 3, 3)."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_aa = torch.where(small, torch.ones_like(axis_angle), axis_angle)
    angle = torch.linalg.norm(safe_aa, dim=-1, keepdim=True)
    K = _skew(safe_aa / angle)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(K.shape)
    R_full = eye + s * K + (1.0 - c) * torch.matmul(K, K)
    # Taylor: R ≈ I + K*theta for tiny angles, with K built from the raw vector
    R_small = eye + _skew(axis_angle)
    return torch.where(small[..., None], R_small, R_full)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3). Via quaternion for numerical robustness."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (..., 4) -> (..., 3, 3)."""
    q = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) with w >= 0.

    Branch-free Shepperd's method: compute all four candidate quaternions
    and select the one keyed to the largest diagonal combination.
    """
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def cand(parts, sq):
        root = torch.sqrt(torch.clamp(sq, min=_EPS))
        return torch.stack(parts, dim=-1) / (2.0 * root[..., None])

    cand_w = cand([qw2, m21 - m12, m02 - m20, m10 - m01], qw2)
    cand_x = cand([m21 - m12, qx2, m01 + m10, m02 + m20], qx2)
    cand_y = cand([m02 - m20, m01 + m10, qy2, m12 + m21], qy2)
    cand_z = cand([m10 - m01, m02 + m20, m12 + m21, qz2], qz2)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    quat = torch.gather(cands, -2, idx)[..., 0, :]
    quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=_EPS)
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    q = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=_EPS)
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0 -> angle in [0, pi]
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_v = torch.where(small, torch.ones_like(v), v)
    sin_half = torch.linalg.norm(safe_v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, w)
    # small-angle: angle/sin_half -> 2/w (w ~ 1)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / sin_half)
    return v * scale


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_aa = torch.where(small, torch.ones_like(axis_angle), axis_angle)
    angle = torch.linalg.norm(safe_aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sin(x/2)/x -> 1/2 - x^2/48 as x -> 0
    sinc_half = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, axis_angle * sinc_half], dim=-1)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two rows flattened (pytorch3d convention)."""
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt (pytorch3d convention).

    Degenerate inputs (zero rows) take fixed fallback axes through the
    double-where pattern so the backward pass stays NaN-free."""
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    ex, ey, ez = torch.eye(3, dtype=d6.dtype, device=d6.device).unbind(0)
    ex, ey, ez = ex.expand_as(a1), ey.expand_as(a1), ez.expand_as(a1)

    deg1 = torch.sum(a1 * a1, dim=-1, keepdim=True) < _EPS
    a1s = torch.where(deg1, ex, a1)
    b1 = a1s / torch.linalg.norm(a1s, dim=-1, keepdim=True)

    b2r = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    deg2 = torch.sum(b2r * b2r, dim=-1, keepdim=True) < _EPS
    # fallback: any vector not collinear with b1
    alt = ey - torch.sum(b1 * ey, dim=-1, keepdim=True) * b1
    alt = torch.where(torch.sum(alt * alt, dim=-1, keepdim=True) < _EPS, ez, alt)
    b2s = torch.where(deg2, alt, b2r)
    b2 = b2s / torch.linalg.norm(b2s, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)
