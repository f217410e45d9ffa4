"""Visualization helpers: SMPL-X mesh overlay render + video export
(counterpart of exavatar_release_tpu/utils/vis.py).

Replaces the reference's pytorch3d-based overlay renderer
(reference avatar/common/utils/vis.py:73-109: rasterize the mesh with flat
shading and alpha-blend over the video frame) and the cv2 video writers the
tools use (e.g. fitting/main/fit.py:195-207).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.mesh_raster import rasterize_mesh


def render_mesh_overlay(
    img_hwc: np.ndarray,
    verts_cam: torch.Tensor,
    faces,
    focal,
    princpt,
    color: Tuple[float, float, float] = (0.8, 0.8, 0.8),
    blend: float = 0.7,
    light_dir: Tuple[float, float, float] = (0.0, 0.0, -1.0),
) -> np.ndarray:
    """Alpha-blend a flat-shaded mesh render over an HWC [0,1] image. The
    mesh is rasterized, shaded and blended on the vertices' device; the
    result comes back as numpy."""
    H, W = img_hwc.shape[:2]
    verts_cam = torch.as_tensor(verts_cam, dtype=torch.float32).detach()
    dev = verts_cam.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(faces), device=dev).long()
    frags = rasterize_mesh(verts_cam, f, f32(focal), f32(princpt), (H, W))
    v0, v1, v2 = verts_cam[f[:, 0]], verts_cam[f[:, 1]], verts_cam[f[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=1)
    fn = fn / torch.clamp(torch.linalg.norm(fn, dim=1, keepdim=True), min=1e-12)
    lam = torch.abs(fn @ f32(light_dir))  # two-sided lambert
    pf = frags.pix_to_face.long()
    hit = pf >= 0
    shade = torch.where(hit, 0.3 + 0.7 * lam[pf.clamp(min=0)], 0.0)
    img = f32(img_hwc)
    overlay = shade[..., None] * f32(color)
    out = torch.where(hit[..., None], (1 - blend) * img + blend * overlay, img)
    return out.cpu().numpy()


def write_video(path: str, frames_hwc: Sequence[np.ndarray], fps: int = 30) -> None:
    """Write [0,1] HWC RGB frames to an mp4 with cv2, imported here: where cv2
    is not installed this raises ImportError."""
    import cv2

    assert len(frames_hwc) > 0
    H, W = frames_hwc[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for fr in frames_hwc:
        vw.write((np.clip(fr, 0, 1)[..., ::-1] * 255).astype(np.uint8))
    vw.release()
