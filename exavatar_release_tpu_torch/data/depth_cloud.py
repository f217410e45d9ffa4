"""Background point cloud from monocular depth predictions (counterpart of
exavatar_release_tpu/data/depth_cloud.py).

The algorithmic half of the reference's Depth-Anything shim (reference
fitting/tools/code_to_copy/run_depth_anything.py:82-121): rescale the
relative depth map onto the SMPL-X mesh's rendered metric depth (mean
absolute deviation matching), accumulate background pixels over frames, and
back-project into a colored point cloud. The depth network itself stays an
external pluggable step; this module turns its outputs into the
``bkg_point_cloud.txt`` the avatar stage consumes.

Everything runs on the device of the tensors it is given: on the card a
1080p frame's accumulators (float64 depth, color and count, ~83 MB) stay
there across frames and only the finished cloud comes to the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.mesh_raster import rasterize_mesh


def _f32_on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def render_smplx_depth(
    verts_cam: torch.Tensor,
    faces,
    focal,
    princpt,
    img_shape: Tuple[int, int],
) -> torch.Tensor:
    """(H, W) float32 metric depth of the posed mesh, 0 where no mesh, on
    ``verts_cam``'s device."""
    dev = verts_cam.device
    frags = rasterize_mesh(verts_cam.float(), torch.as_tensor(np.asarray(faces), device=dev),
                           _f32_on(focal, dev), _f32_on(princpt, dev), img_shape)
    z = frags.zbuf
    return torch.where(torch.isfinite(z), z, 0.0)


def align_depth_to_smplx(
    rel_depth: torch.Tensor,  # (H, W) relative depth, LOW = close
    smplx_depth: torch.Tensor,  # (H, W) metric depth render, 0 = background
) -> torch.Tensor:
    """Scale+shift the relative depth onto the mesh's metric depth by
    matching the mean absolute deviation over mesh pixels, in float64
    (reference run_depth_anything.py:93-98; the JAX package takes the
    render's mean and deviation in float32, which moves its result by a few
    float32 ulps). Fewer than 16 mesh pixels: ``rel_depth`` unchanged."""
    fg = smplx_depth > 0
    if int(fg.sum()) < 16:
        return rel_depth
    d = rel_depth.double()
    s = smplx_depth.double()[fg]
    scale = torch.abs(d[fg] - d[fg].mean()).mean()
    scale_s = torch.abs(s - s.mean()).mean()
    d = d / torch.clamp(scale, min=1e-9) * scale_s
    d = d - d[fg].mean() + s.mean()
    return d.float()


class BkgCloudAccumulator:
    """Per-frame accumulation of background depth/color (reference
    run_depth_anything.py:100-108) + final back-projection (109-121), in
    float64 tensors on ``device``."""

    def __init__(self, img_shape: Tuple[int, int], device="cpu"):
        H, W = img_shape
        kw = dict(dtype=torch.float64, device=device)
        self.depth = torch.zeros((H, W), **kw)
        self.color = torch.zeros((H, W, 3), **kw)
        self.count = torch.zeros((H, W), **kw)

    def add(self, aligned_depth: torch.Tensor, img_rgb: torch.Tensor,
            human_mask: torch.Tensor) -> None:
        """img_rgb (H, W, 3) in [0, 1]; human_mask (H, W) 1 = human."""
        is_bkg = human_mask < 0.5
        self.depth += aligned_depth * is_bkg
        self.color += img_rgb * is_bkg[..., None]
        self.count += is_bkg

    def point_cloud(self, focal, princpt) -> torch.Tensor:
        """(N, 6) float32 [xyz in camera frame, rgb 0..1] of all
        seen-background pixels in row-major order, averaged over frames."""
        H, W = self.depth.shape
        dev = self.depth.device
        focal, princpt = np.asarray(focal, np.float64), np.asarray(princpt, np.float64)
        seen = self.count > 0
        z = self.depth / torch.clamp(self.count, min=1e-6)
        c = self.color / torch.clamp(self.count, min=1e-6)[..., None]
        ii, jj = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                                torch.arange(W, device=dev, dtype=torch.float64), indexing="ij")
        x = (jj - princpt[0]) / focal[0] * z
        y = (ii - princpt[1]) / focal[1] * z
        pts = torch.stack([x[seen], y[seen], z[seen]], dim=1)
        return torch.cat([pts, c[seen]], dim=1).float()


def save_bkg_point_cloud(path: str, cloud) -> None:
    """``cloud`` (N, 6) as text, six ``%.6f`` columns a line: the bytes of
    ``np.savetxt(path, cloud, fmt="%.6f")``, formatted in one pass over the
    rows as Python floats (a 1080p cloud has ~2M rows)."""
    cloud = cloud.cpu().numpy() if isinstance(cloud, torch.Tensor) else np.asarray(cloud)
    row = " ".join(["%.6f"] * cloud.shape[1]) + "\n"
    with open(path, "w") as f:
        f.write("".join([row % tuple(r) for r in cloud.tolist()]))
