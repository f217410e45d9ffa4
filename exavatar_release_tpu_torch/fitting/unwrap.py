"""Face texture unwrapping into UV space (counterpart of
exavatar_release_tpu/fitting/unwrap.py; reference XY2UV +
fitting/main/unwrap.py:34-91).

Pipeline per frame: rasterize the mesh in UV space ONCE to get per-UV-pixel
(face index, barycentrics) — precompute; pose the FLAME mesh with the
fitted params; project the surface point of every UV pixel into the image;
visibility-test against a camera-space z-buffer of the same mesh; bilinearly
sample the video frame; average valid samples over frames.

The UV-space rasterization reuses the mesh rasterizer with z == 1 (a
perspective camera at focal 1 over a z=1 plane IS an orthographic map,
matching the reference's OrthographicCameras path,
fitting/common/nets/layer.py:41-51).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.grid_sample import grid_sample_2d
from ..ops.mesh_raster import rasterize_mesh


class UVMaps(NamedTuple):
    face_idx: torch.Tensor  # (Hu, Wu) int32, -1 outside the atlas
    bary: torch.Tensor  # (Hu, Wu, 3)


@torch.no_grad()
def build_uv_maps(
    vertex_uv: torch.Tensor,  # (Vt, 2) in [0, 1]
    face_uv: torch.Tensor,  # (F, 3) indices into vertex_uv
    uvmap_shape: Tuple[int, int],
) -> UVMaps:
    """Precompute per-UV-pixel face index + barycentrics (reference
    XY2UV.__init__ via get_face_index_map_uv, layer.py:13-27,41-51)."""
    Hu, Wu = uvmap_shape
    dev = vertex_uv.device
    # UV -> "camera" space at z=1: px = u * Wu, py = v * Hu with focal=1
    verts_cam = torch.stack(
        [vertex_uv[:, 0] * Wu, vertex_uv[:, 1] * Hu, torch.ones_like(vertex_uv[:, 0])], dim=1)
    frags = rasterize_mesh(verts_cam, face_uv, torch.ones(2, device=dev),
                           torch.zeros(2, device=dev), uvmap_shape, max_per_tile=512)
    return UVMaps(face_idx=frags.pix_to_face, bary=frags.bary)


@torch.no_grad()
def unwrap_frame(
    uv_maps: UVMaps,
    mesh_cam: torch.Tensor,  # (V, 3) posed FLAME mesh, camera space
    faces: torch.Tensor,  # (F, 3) FLAME topology (same as face_uv order)
    img: torch.Tensor,  # (3, H, W) video frame in [0, 1]
    focal: torch.Tensor,
    princpt: torch.Tensor,
    z_tol: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's contribution: (texture (3, Hu, Wu), weight (1, Hu, Wu)).

    Visibility: the UV pixel's surface point must win (within ``z_tol``) the
    camera z-buffer of the mesh (reference unwrap.py:54-76).
    """
    H, W = img.shape[1:]
    Hu, Wu = uv_maps.face_idx.shape
    sel = torch.clamp(uv_maps.face_idx.long(), min=0)
    tri = mesh_cam[faces.long()[sel]]  # (Hu, Wu, 3, 3)
    pts = torch.einsum("hwk,hwkc->hwc", uv_maps.bary, tri)  # surface points

    z = torch.clamp(pts[..., 2], min=1e-6)
    px = pts[..., 0] / z * focal[0] + princpt[0]
    py = pts[..., 1] / z * focal[1] + princpt[1]

    # z-buffer visibility from the camera
    frags_cam = rasterize_mesh(mesh_cam, faces, focal, princpt, (H, W))
    ix = torch.clamp(px.to(torch.int64), 0, W - 1)  # truncation toward 0, as astype
    iy = torch.clamp(py.to(torch.int64), 0, H - 1)
    visible = z <= frags_cam.zbuf[iy, ix] + z_tol

    in_img = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    valid = (uv_maps.face_idx >= 0) & visible & in_img & (z > 1e-4)

    # bilinear sample the frame
    gx = (px + 0.5) / W * 2.0 - 1.0
    gy = (py + 0.5) / H * 2.0 - 1.0
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    colors = grid_sample_2d(img, coords).reshape(Hu, Wu, 3)

    w = valid.float()[None]
    return colors.permute(2, 0, 1) * w, w


@torch.no_grad()
def unwrap_sequence(
    uv_maps: UVMaps,
    meshes_cam: torch.Tensor,  # (F, V, 3)
    faces: torch.Tensor,
    imgs: torch.Tensor,  # (F, 3, H, W)
    focals: torch.Tensor,  # (F, 2)
    princpts: torch.Tensor,  # (F, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Average unwrap over frames (reference unwrap.py:76-91). Returns
    (texture (3, Hu, Wu), texture_mask (1, Hu, Wu))."""
    Hu, Wu = uv_maps.face_idx.shape
    tex_sum = torch.zeros(3, Hu, Wu, device=imgs.device)
    w_sum = torch.zeros(1, Hu, Wu, device=imgs.device)
    for mesh, img, fo, pp in zip(meshes_cam, imgs, focals, princpts):
        tex, w = unwrap_frame(uv_maps, mesh, faces, img, fo, pp)
        tex_sum += tex
        w_sum += w
    tex = tex_sum / torch.clamp(w_sum, min=1.0)
    return tex, (w_sum > 0).float()
