"""Differentiable one-face-per-pixel mesh rasterizer and UV texture renderer
(counterpart of exavatar_release_tpu/ops/mesh_raster.py).

Faces are binned to image tiles with the Gaussian rasterizer's binning
(bounding circle -> tile rectangle); each tile then z-tests its face list
over its pixels with vectorized edge functions, 64 faces at a time. The
choice of the winning face is not differentiable; barycentrics are then
computed again, differentiably, for the winner, so gradients reach the
vertices through the barycentrics and the texture through the UV sample.

Pixel (i, j) has its center at (j + 0.5, i + 0.5); projection is
px = fx x / z + cx. Barycentrics are perspective-correct.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .grid_sample import grid_sample_2d
from .rasterizer.binning import bin_gaussians, tile_grid

_FACE_CHUNK = 64  # faces z-tested at once
_TILE_BATCH = 256  # tiles z-tested at once: bounds the (tiles, P, 64) temporaries


class MeshFragments(NamedTuple):
    pix_to_face: torch.Tensor  # (H, W) int32, -1 = background
    bary: torch.Tensor  # (H, W, 3) perspective-correct barycentrics
    zbuf: torch.Tensor  # (H, W) view-space z of the hit (inf = background)


def _edge_bary(px, py, v0, v1, v2):
    """Screen-space barycentrics of pixels against triangles with (..., 2)
    screen vertices; px, py broadcast against the face axis. Returns
    (b0, b1, b2, area)."""
    x0, y0 = v0[..., 0], v0[..., 1]
    x1, y1 = v1[..., 0], v1[..., 1]
    x2, y2 = v2[..., 0], v2[..., 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
    w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
    w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
    safe = torch.where(torch.abs(area) < 1e-12, 1.0, area)
    return w0 / safe, w1 / safe, w2 / safe, area


@torch.no_grad()
def _select_faces(tri, inv_z3, face_ids, px, py, num_faces: int):
    """Z-buffer winner per pixel. tri (F+1, 3, 2), inv_z3 (F+1, 3) with a
    dummy last face; face_ids (T, K) with K a multiple of 64, F = miss;
    px, py (T, P). Returns (best_z (T, P), best_face (T, P) int64, -1 =
    none). At equal z the first face in depth-key order stays."""
    T, P = px.shape
    best_z = torch.full((T, P), torch.inf, device=px.device)
    best_f = torch.full((T, P), -1, dtype=torch.int64, device=px.device)
    for k0 in range(0, face_ids.shape[1], _FACE_CHUNK):
        f_chunk = face_ids[:, k0:k0 + _FACE_CHUNK]  # (T, c)
        t = tri[f_chunk]  # (T, c, 3, 2)
        iz = inv_z3[f_chunk][:, None]  # (T, 1, c, 3)
        b0, b1, b2, area = _edge_bary(
            px[:, :, None], py[:, :, None], t[:, None, :, 0], t[:, None, :, 1], t[:, None, :, 2]
        )  # (T, P, c); area (T, 1, c)
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (torch.abs(area) > 1e-12)
        inside = inside & (f_chunk < num_faces)[:, None, :]
        # perspective-correct depth: 1 / sum(b_i / z_i)
        invz_pix = b0 * iz[..., 0] + b1 * iz[..., 1] + b2 * iz[..., 2]
        zpix = 1.0 / torch.clamp(invz_pix, min=1e-12)
        zpix = torch.where(inside, zpix, torch.inf)
        zmin, amin = torch.min(zpix, dim=2)  # the first minimum wins
        fwin = torch.gather(f_chunk, 1, amin)
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_f = torch.where(better, fwin, best_f)
    return best_z, best_f


def rasterize_mesh(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    img_shape: Tuple[int, int],
    tile_h: int = 8,
    tile_w: int = 128,
    max_per_tile: int = 512,
    z_near: float = 1e-4,
) -> MeshFragments:
    """Z-buffer rasterization of a camera-space mesh. verts_cam: (V, 3) with
    +z forward; faces: (F, 3) int. Returns per-pixel winning face,
    perspective-correct barycentrics and depth."""
    H, W = int(img_shape[0]), int(img_shape[1])
    ny, nx = tile_grid((H, W), tile_h, tile_w)
    faces = faces.long()
    F = faces.shape[0]
    dev = verts_cam.device

    z = verts_cam[:, 2]
    safe_z = torch.where(z > z_near, z, 1.0)
    sx = verts_cam[:, 0] / safe_z * focal[0] + princpt[0]
    sy = verts_cam[:, 1] / safe_z * focal[1] + princpt[1]
    screen = torch.stack([sx, sy], dim=1)  # (V, 2)
    inv_z = 1.0 / safe_z

    tri = screen[faces]  # (F, 3, 2)
    with torch.no_grad():
        tri_z_ok = (z[faces] > z_near).all(dim=1)  # cull faces crossing the near plane
        lo = tri.min(dim=1).values
        hi = tri.max(dim=1).values
        center = 0.5 * (lo + hi)
        radius = 0.5 * torch.linalg.norm(hi - lo, dim=1) + 1.0
        depth_key = z[faces].min(dim=1).values
        binning = bin_gaussians(center, torch.where(tri_z_ok, radius, 0.0), depth_key, tri_z_ok,
                                (H, W), tile_h, tile_w, max_per_tile)
        # per-tile face ids (F = sentinel -> degenerate dummy face)
        order_pad = torch.cat([binning.order.long(), torch.full((1,), F, device=dev)])
        face_ids = order_pad[binning.tile_indices.long()]  # (T, K)
        pad_k = -face_ids.shape[1] % _FACE_CHUNK
        face_ids = torch.nn.functional.pad(face_ids, (0, pad_k), value=F)
        tri_pad = torch.cat([tri, torch.zeros(1, 3, 2, device=dev)], dim=0)
        invz_pad = torch.cat([inv_z[faces], torch.ones(1, 3, device=dev)], dim=0)

        # pixel centers per tile, (T, P)
        t_ids = torch.arange(ny * nx, device=dev)
        ox = ((t_ids % nx) * tile_w).float()
        oy = ((t_ids // nx) * tile_h).float()
        i = torch.arange(tile_h * tile_w, device=dev)
        px = ox[:, None] + ((i % tile_w).float() + 0.5)[None, :]
        py = oy[:, None] + ((i // tile_w).float() + 0.5)[None, :]

        bz, bf = [], []
        for t0 in range(0, ny * nx, _TILE_BATCH):
            sl = slice(t0, t0 + _TILE_BATCH)
            z_b, f_b = _select_faces(tri_pad, invz_pad, face_ids[sl], px[sl], py[sl], F)
            bz.append(z_b)
            bf.append(f_b)

        def tiles_to_img(x):
            x = x.reshape(ny, nx, tile_h, tile_w)
            return x.permute(0, 2, 1, 3).reshape(ny * tile_h, nx * tile_w)[:H, :W]

        pix_face = tiles_to_img(torch.cat(bf))
        zbuf = tiles_to_img(torch.cat(bz))

    # differentiable barycentrics of the winning face
    pj = (torch.arange(W, device=dev).float() + 0.5)[None, :].expand(H, W)
    pi = (torch.arange(H, device=dev).float() + 0.5)[:, None].expand(H, W)
    sel = torch.clamp(pix_face, min=0)
    t = tri[sel]  # (H, W, 3, 2), differentiable w.r.t. the vertices
    b0, b1, b2, _ = _edge_bary(pj, pi, t[..., 0, :], t[..., 1, :], t[..., 2, :])
    iz = inv_z[faces][sel]  # (H, W, 3)
    # perspective correction: w_i ~ b_i / z_i
    pw = torch.stack([b0, b1, b2], dim=-1) * iz
    pw = pw / torch.clamp(pw.sum(-1, keepdim=True), min=1e-12)
    hit = (pix_face >= 0)[..., None]
    bary = torch.where(hit, pw, 0.0)
    return MeshFragments(pix_to_face=pix_face.to(torch.int32), bary=bary, zbuf=zbuf)


def sample_uv_texture(uvmap: torch.Tensor, fragments: MeshFragments, face_uv: torch.Tensor,
                      vertex_uv: torch.Tensor, bg_value: float = -1.0) -> torch.Tensor:
    """Sample a UV texture through fragments. uvmap: (C, Ht, Wt); face_uv:
    (F, 3) indices into vertex_uv (Vt, 2), uv in [0, 1] with v = 0 at texture
    row 0. Background pixels get ``bg_value`` on every channel. Returns
    (C, H, W)."""
    H, W = fragments.pix_to_face.shape
    C = uvmap.shape[0]
    sel = torch.clamp(fragments.pix_to_face.long(), min=0)
    uv_tri = vertex_uv[face_uv.long()[sel]]  # (H, W, 3, 2)
    uv = torch.einsum("hwk,hwkc->hwc", fragments.bary, uv_tri)  # (H, W, 2)
    coords = uv.reshape(-1, 2) * 2.0 - 1.0
    vals = grid_sample_2d(uvmap, coords).reshape(H, W, C)
    hit = (fragments.pix_to_face >= 0)[..., None]
    return torch.where(hit, vals, bg_value).permute(2, 0, 1)


def render_textured_mesh(uvmap, verts_world, faces, R, t, focal, princpt,
                         img_shape: Tuple[int, int], face_uv, vertex_uv,
                         max_per_tile: int = 512) -> torch.Tensor:
    """World->camera transform, z-buffer raster, UV texture sample, -1
    background. Returns (C, H, W)."""
    verts_cam = verts_world @ R.T + t[None, :]
    frags = rasterize_mesh(verts_cam, faces, focal, princpt, img_shape, max_per_tile=max_per_tile)
    return sample_uv_texture(uvmap, frags, face_uv, vertex_uv)
