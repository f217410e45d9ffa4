"""Real spherical-harmonics color evaluation, degrees 0..4 (counterpart of
exavatar_release_tpu/core/sh.py).

The graphdeco-inria 3DGS convention: RGB = clamp(SH(view_dir) + 0.5, 0). The
active degree is a float scalar that masks whole bands, so one expression
serves the SH-degree schedule.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)

MAX_SH_BANDS = 25  # (4+1)^2


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values for unit directions. dirs: (..., 3) -> (..., 25)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    basis = [
        C0 * one,
        -C1 * y,
        C1 * z,
        -C1 * x,
        C2[0] * xy,
        C2[1] * yz,
        C2[2] * (2.0 * zz - xx - yy),
        C2[3] * xz,
        C2[4] * (xx - yy),
        C3[0] * y * (3 * xx - yy),
        C3[1] * xy * z,
        C3[2] * y * (4 * zz - xx - yy),
        C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        C3[4] * x * (4 * zz - xx - yy),
        C3[5] * z * (xx - yy),
        C3[6] * x * (xx - 3 * yy),
        C4[0] * xy * (xx - yy),
        C4[1] * yz * (3 * xx - yy),
        C4[2] * xy * (7 * zz - 1),
        C4[3] * yz * (7 * zz - 3),
        C4[4] * (zz * (35 * zz - 30) + 3),
        C4[5] * xz * (7 * zz - 3),
        C4[6] * (xx - yy) * (7 * zz - 1),
        C4[7] * xz * (xx - 3 * yy),
        C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
    ]
    return torch.stack(basis, dim=-1)


def band_mask(active_degree, num_bands: int, device=None) -> torch.Tensor:
    """(num_bands,) float mask: 1 for bands l*l..(l+1)^2-1 with l <= degree.
    ``active_degree`` is a Python number or a scalar tensor."""
    band_idx = torch.arange(num_bands, device=device)
    band_deg = torch.floor(torch.sqrt(band_idx.float() + 1e-6)).to(torch.int32)
    band_deg = torch.where(band_idx == 0, 0, band_deg)
    deg = torch.as_tensor(active_degree, device=device).to(torch.int32)
    return (band_deg <= deg).float()


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH evaluation at a fixed degree 0..4.
    sh: (..., C, B) with B >= (deg+1)^2; dirs: (..., 3) -> (..., C)."""
    assert 0 <= deg <= 4
    coeff = (deg + 1) ** 2
    assert sh.shape[-1] >= coeff
    basis = sh_basis(dirs)[..., :coeff]
    return torch.einsum("...cb,...b->...c", sh[..., :coeff], basis)


def eval_sh_dynamic(active_degree, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH evaluation with the bands above ``active_degree`` masked out.
    sh: (..., C, B); dirs: (..., 3) -> (..., C)."""
    num_bands = sh.shape[-1]
    basis = sh_basis(dirs)[..., :num_bands]
    mask = band_mask(active_degree, num_bands, device=sh.device)
    return torch.einsum("...cb,...b->...c", sh, basis * mask)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC band: (rgb - 0.5) / C0."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh_dc: torch.Tensor) -> torch.Tensor:
    return sh_dc * C0 + 0.5
