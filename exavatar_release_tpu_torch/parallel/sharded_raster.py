"""Row-band-sharded differentiable rasterization (counterpart of
exavatar_release_tpu/parallel/sharded_raster.py).

The image's tile rows are split into D bands, one per rank of a mesh axis.
A rank bins the Gaussians against its own band, with the band's tile-row
offset in the binning and its global row offset in the compositing kernel
(kernel 1 / 2 dense, kernel 7 / 8 pair-major), so its tiles are those of
the single-device render, and composites them.

Entry points, as in the JAX package:

- ``rasterize_sharded`` and ``rasterize_gaussian_sharded``: standalone, over
  a ``LocalMesh`` of this process's devices. The ranks' work runs in turn
  and the collectives are tensor operations: the bands' gather is a
  ``torch.cat``, the exchange's ``all_to_all`` a transposition of the send
  buffers. Autograd through them gives what the collectives' transposes
  give in JAX.
- ``rasterize_in_context`` and ``rasterize_gaussian_sharded_in_context``:
  for one rank of a ``ProcessMesh`` (the data x tile train step), with the
  collectives of ``parallel/collectives.py`` over the axis's process group;
  every rank gets the full image.

The Gaussian-sharded renders also shard the Gaussians: each rank projects
its N/D slice, finds which bands each Gaussian touches, and one
``all_to_all`` delivers every survivor to those bands' ranks, in buckets of
``cap`` rows per (source, band). The bucketing runs on the source rank
(``_bucket_for_bands``): a stable depth order with invisible rows last, so
an overflowing bucket drops its deepest pairs (counted in
``exchange_overflow``), and a slot -> source-row table through which the
send buffer is gathered (``index_select``, whose backward is
``index_add_``), not scattered. Communication per rank and step: the band
(rows/D, W, 5) gathered forward and reduce-scattered backward, and
D * cap rows of 15 float32 each way for the exchange (``exchange_bytes``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core.camera import Camera
from ..ops.rasterizer import kernels
from ..ops.rasterizer.api import (
    RasterizeSettings,
    _CompositeDense,
    _CompositeRagged,
    _row_table,
    _take_rows,
)
from ..ops.rasterizer.binning import bin_gaussians_ragged, bin_gaussians_sorted, tile_grid
from ..ops.rasterizer.preprocess import project_gaussians
from . import collectives as coll

# columns of the exchange's payload rows: params (8), color (4; its last is
# the depth), radius, extent (2)
PAYLOAD_COLS = 15


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_exchange_cap(n: int, d: int) -> int:
    """The per-(source rank -> band) bucket capacity that the Gaussian-sharded
    renders use when ``settings.exchange_cap <= 0``: 4·ceil(N/D²) (at least
    4x a uniform scene's expectation), 128-aligned, and never more than the
    per-rank slice N/D. ``train.loop.RasterCapacityGovernor`` grows from
    this value, never below it."""
    n_pad = _round_up(n, d)
    cap = _round_up(max(4 * (-(-n_pad // (d * d))), 128), 128)
    return min(cap, n_pad // d)


def _render_band(params, color, mean2d, radius, depth, visible, band: int, rows_per_dev: int,
                 W: int, settings: RasterizeSettings, bg: torch.Tensor,
                 extent: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render row band ``band`` (global rows [band·rows_per_dev, ...)) of
    the Gaussians given, on their device. Returns (rows_per_dev, W, 5) =
    [rgb over bg, depth, mask] and the (2,) int32 [dropped pairs,
    truncated]. Dense: the pair-sort binning and kernel 1 (2 backward) with
    the tiles' origins in global pixels; pair-major: the ragged binning and
    kernel 7 (8) at ``oy_off`` = the band's first row; ``backend="ref"``:
    kernel 1's plain version under autograd. ``kernel_v`` is ignored, as in
    the JAX package. ``extent`` (n, 2): the tight per-axis boxes."""
    th, tw = settings.tile_h, settings.tile_w
    ny, nx = tile_grid((rows_per_dev, W), th, tw)
    row0 = float(band * rows_per_dev)
    offset = band * (rows_per_dev // th)
    n_loc = params.shape[0]
    ext = None if extent is None else extent.detach()
    rows_pad = _row_table(params, color)
    bg = bg.float().contiguous()
    if settings.pair_major and settings.backend != "ref":
        chunk = settings.ragged_chunk()
        max_pairs = (settings.max_pairs if settings.max_pairs > 0
                     else settings.pairs_per_gaussian * n_loc)
        rb = bin_gaussians_ragged(mean2d.detach(), radius.detach(), depth.detach(), visible,
                                  (rows_per_dev, W), th, tw, chunk=chunk, max_pairs=max_pairs,
                                  extent=ext, tile_row_offset=offset)
        order_pad = torch.cat([rb.order.long(), rb.order.new_full((1,), n_loc).long()])
        g2 = order_pad[rb.pair_rank.long()]
        rows2 = _take_rows(rows_pad, g2).T.contiguous()  # (12, Pa)
        full_t = _CompositeRagged.apply(rows2, rb.tid, rb.flags, bg, row0, (th, tw), ny * nx,
                                        chunk, nx)
        dropped = torch.stack([rb.n_dropped_pairs, rb.n_truncated])
    else:
        b = bin_gaussians_sorted(mean2d.detach(), radius.detach(), depth.detach(), visible,
                                 (rows_per_dev, W), th, tw, settings.max_per_tile,
                                 max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                                 extent=ext, tile_row_offset=offset)
        order_pad = torch.cat([b.order.long(), b.order.new_full((1,), n_loc).long()])
        tile_rows = _take_rows(rows_pad, order_pad[b.tile_indices.long()])  # (T, K, 12)
        t_ids = torch.arange(ny * nx, device=params.device)
        origins = torch.stack([(t_ids % nx) * tw, (t_ids // nx) * th], dim=1).float()
        origins[:, 1] += row0  # global pixel rows, as the conic rows are
        win = tile_rows.transpose(1, 2).contiguous()  # (T, 12, K)
        if settings.backend == "ref":
            full_t = kernels.composite_tiles_fwd_cm_plain(win, b.tile_counts, origins, bg,
                                                          (th, tw))
        else:
            full_t = _CompositeDense.apply(win, b.tile_counts, origins, bg, (th, tw))
        dropped = torch.stack([b.n_dropped_pairs, b.n_truncated])
    full = (full_t.reshape(ny, nx, 5, th, tw).permute(0, 3, 1, 4, 2)
            .reshape(ny * th, nx * tw, 5))
    return full[:, :W], dropped


def _finalize(full: torch.Tensor, mean2d: torch.Tensor,
              radius: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"img": full[..., 0:3], "depth": full[..., 3], "mask": full[..., 4],
            "mean2d": mean2d, "radius": radius, "is_vis": radius > 0}


def _dropped_counts(out: Dict[str, torch.Tensor], dropped: torch.Tensor,
                    extra: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``dropped`` (2,) summed over the bands: pairs, truncated."""
    total = dropped[0] + dropped[1]
    out["n_dropped"] = total if extra is None else total + extra
    out["n_dropped_pairs"] = dropped[0]
    out["n_truncated"] = dropped[1]
    return out


def _bands(H: int, settings: RasterizeSettings, D: int) -> int:
    """Rows per band: H rounded up to tile_h·D, split D ways."""
    return _round_up(H, settings.tile_h * D) // D


def _camera_on(cam: Camera, device) -> Camera:
    return Camera(*(x.to(device) for x in cam))


def rasterize_in_context(means3d, scales, quats, opacities, rgbs, live, cam: Camera,
                         img_shape: Tuple[int, int], bg: torch.Tensor, mesh, axis: str,
                         axis_size: int, settings: RasterizeSettings,
                         mean2d_offset: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Row-band render for one rank of ``mesh[axis]`` (a ``ProcessMesh``),
    the Gaussians replicated over the axis. Returns the full image dict on
    every rank: the bands are exchanged with one tiled all_gather, whose
    backward reduce-scatters the pixel cotangents back to their bands."""
    H, W = int(img_shape[0]), int(img_shape[1])
    assert mesh.shape[axis] == axis_size, (mesh.shape, axis, axis_size)
    group = mesh.group(axis)
    rows_per_dev = _bands(H, settings, axis_size)
    screen = project_gaussians(means3d, scales, quats, opacities, rgbs, live, cam, (H, W),
                               mean2d_offset)
    band, dropped = _render_band(screen.params, screen.color, screen.mean2d, screen.radius,
                                 screen.depth, screen.in_frustum, mesh.index(axis),
                                 rows_per_dev, W, settings, bg, extent=screen.extent)
    full = coll.all_gather(band, group)[:H]
    out = _finalize(full, screen.mean2d, screen.radius)
    return _dropped_counts(out, coll.psum(dropped, group))


def _bucket_for_bands(payload: torch.Tensor, y: torch.Tensor, radius: torch.Tensor,
                      visible: torch.Tensor, D: int, rows_per_dev: int, cap: int,
                      depth: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rank-local half of the exchange (the JAX package's
    ``_exchange_to_bands`` before its ``all_to_all``): route each local
    Gaussian's payload row to every row band it touches.

    payload (n_loc, C): differentiable rows; y / radius / visible (n_loc,)
    pick the bands (under no gradient). Returns the (D*cap, C) send buffer,
    rows [d·cap, (d+1)·cap) for band d, its (D*cap,) validity, and the count
    of (Gaussian, band) pairs that found no slot. With ``depth`` the rows
    take their slots in ascending depth, invisible rows last, so an
    overflowing bucket drops its deepest pairs; without it, in row order.
    The buffer is gathered through a slot -> source-row table (row n_loc is
    zeros), so its backward is an ``index_add_``."""
    n_loc, C = payload.shape
    dev = payload.device
    if depth is not None:
        key = torch.where(visible, depth.detach(), torch.inf)
        perm = torch.argsort(key, stable=True)
    else:
        perm = torch.arange(n_loc, device=dev)
    y, r, vis = y.detach()[perm], radius.detach()[perm], visible[perm]
    scale = 1.0 / float(rows_per_dev)
    b_lo = torch.clamp(torch.floor((y - r) * scale), 0, D - 1).long()
    b_hi = torch.clamp(torch.floor((y + r) * scale), 0, D - 1).long()
    d_ids = torch.arange(D, device=dev)[None, :]
    hit = vis[:, None] & (d_ids >= b_lo[:, None]) & (d_ids <= b_hi[:, None])
    slots = torch.cumsum(hit.long(), dim=0) - 1  # per-band bucket slot
    ok = hit & (slots < cap)
    overflow = (hit.sum() - ok.sum()).to(torch.int32)
    src = torch.full((D * cap,), n_loc, dtype=torch.long, device=dev)
    src[(d_ids * cap + slots)[ok]] = perm[:, None].expand(n_loc, D)[ok]
    table = torch.cat([payload, payload.new_zeros(1, C)], dim=0)
    return torch.index_select(table, 0, src), src < n_loc, overflow


def _pad_gaussians(D: int, means3d, scales, quats, opacities, rgbs, live, mean2d_offset):
    """Pad N to a multiple of D with dead Gaussians (zeros, live False)."""
    n = means3d.shape[0]
    pad = -n % D
    if mean2d_offset is None:
        mean2d_offset = means3d.new_zeros(n, 2)
    if pad:
        zf = lambda a: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        means3d, scales, quats, opacities, rgbs, live, mean2d_offset = map(
            zf, (means3d, scales, quats, opacities, rgbs, live, mean2d_offset))
    return n, n + pad, (means3d, scales, quats, opacities, rgbs, live, mean2d_offset)


def _project_and_bucket(gs, sl: slice, cam: Camera, H: int, W: int, D: int,
                        rows_per_dev: int, cap: int, device=None):
    """Project the slice ``sl`` of the padded Gaussians ``gs`` and bucket
    it for the bands. Returns (screen, send, vsend, overflow)."""
    m3, sc, qu, op, rg, lv, m2o = (a[sl] if device is None else a[sl].to(device) for a in gs)
    screen = project_gaussians(m3, sc, qu, op, rg, lv, cam, (H, W), m2o)
    payload = torch.cat([screen.params, screen.color, screen.radius[:, None], screen.extent],
                        dim=1)
    # bands picked on the tight y half-extent (<= radius): rows past it have
    # alpha < 1/255, so skipping those bands is exact
    send, vsend, overflow = _bucket_for_bands(payload, screen.mean2d[:, 1], screen.extent[:, 1],
                                              screen.in_frustum, D, rows_per_dev, cap,
                                              depth=screen.depth)
    return screen, send, vsend, overflow


def _render_received(recv, vrecv, band, rows_per_dev, W, settings, bg):
    return _render_band(recv[:, :8], recv[:, 8:12], recv[:, 3:5],
                        torch.where(vrecv, recv[:, 12], 0.0), recv[:, 11], vrecv, band,
                        rows_per_dev, W, settings, bg, extent=recv[:, 13:15])


def rasterize_gaussian_sharded(means3d, scales, quats, opacities, rgbs, live, cam: Camera,
                               img_shape: Tuple[int, int], bg: torch.Tensor, mesh,
                               axis: str = "tile",
                               settings: RasterizeSettings = RasterizeSettings(), cap: int = 0,
                               mean2d_offset: Optional[torch.Tensor] = None
                               ) -> Dict[str, torch.Tensor]:
    """Row-band render over a ``LocalMesh`` with the GAUSSIANS sharded too:
    rank s projects the slice [s·N/D, (s+1)·N/D), buckets it for the bands,
    and band d renders what every rank sent it. Per-rank projection,
    binning and compositing scale as N/D · band overlap.

    ``cap`` bounds each (source rank -> band) bucket; 0 sizes it with
    ``resolve_exchange_cap``. Overflow drops the deepest extra pairs per
    bucket and is reported per rank (``exchange_overflow``, (D,) int32):
    raise ``cap`` if it is ever nonzero. ``exchange_bytes``: D·cap·15
    float32 per rank each way. The gradient reaches each Gaussian through
    its own rank's slice; it needs no extra sum."""
    H, W = int(img_shape[0]), int(img_shape[1])
    D = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    out_dev = means3d.device
    rows_per_dev = _bands(H, settings, D)
    n, n_pad, gs = _pad_gaussians(D, means3d, scales, quats, opacities, rgbs, live,
                                  mean2d_offset)
    if cap <= 0:
        cap = resolve_exchange_cap(n, D)
    n_loc = n_pad // D
    cap = min(cap, n_loc)

    screens, sends, vsends, overflows = [], [], [], []
    for s in range(D):
        screen, send, vsend, overflow = _project_and_bucket(
            gs, slice(s * n_loc, (s + 1) * n_loc), _camera_on(cam, devs[s]), H, W, D,
            rows_per_dev, cap, devs[s])
        screens.append(screen)
        sends.append(send)
        vsends.append(vsend)
        overflows.append(overflow.to(out_dev))
    bands, dropped = [], []
    for d in range(D):
        # the all_to_all: band d's buffer is bucket d of every source, source-major
        recv = torch.cat([x[d * cap:(d + 1) * cap].to(devs[d]) for x in sends])
        vrecv = torch.cat([x[d * cap:(d + 1) * cap].to(devs[d]) for x in vsends])
        band, drop = _render_received(recv, vrecv, d, rows_per_dev, W, settings,
                                      bg.to(devs[d]))
        bands.append(band.to(out_dev))
        dropped.append(drop.to(out_dev))
    full = torch.cat(bands)[:H]
    out = _finalize(full, torch.cat([s.mean2d.to(out_dev) for s in screens])[:n],
                    torch.cat([s.radius.to(out_dev) for s in screens])[:n])
    out["exchange_overflow"] = torch.stack(overflows)
    out["exchange_bytes"] = torch.tensor(float(D * cap * PAYLOAD_COLS * 4), device=out_dev)
    return _dropped_counts(out, torch.stack(dropped).sum(0))


def rasterize_gaussian_sharded_in_context(means3d, scales, quats, opacities, rgbs, live,
                                          cam: Camera, img_shape: Tuple[int, int],
                                          bg: torch.Tensor, mesh, axis: str, axis_size: int,
                                          settings: RasterizeSettings, cap: int = 0,
                                          mean2d_offset: Optional[torch.Tensor] = None
                                          ) -> Dict[str, torch.Tensor]:
    """Gaussian-sharded render for one rank of ``mesh[axis]`` (a
    ``ProcessMesh``) with the Gaussians replicated over the axis, as the
    train step has them. The rank takes its N/D slice, projects and buckets
    it, and the exchange's ``all_to_all`` delivers the survivors to their
    bands. The slice's gradient is zero outside it on this rank: the
    caller's all-reduce over the axis (the data x tile step's) assembles
    the whole gradient. The statistics (mean2d, radius) are gathered back
    to N, so the dict is that of ``rasterize_in_context``."""
    H, W = int(img_shape[0]), int(img_shape[1])
    D = axis_size
    assert mesh.shape[axis] == D, (mesh.shape, axis, D)
    group, d = mesh.group(axis), mesh.index(axis)
    rows_per_dev = _bands(H, settings, D)
    n, n_pad, gs = _pad_gaussians(D, means3d, scales, quats, opacities, rgbs, live,
                                  mean2d_offset)
    if cap <= 0:
        cap = resolve_exchange_cap(n, D)
    n_loc = n_pad // D
    cap = min(cap, n_loc)
    screen, send, vsend, overflow = _project_and_bucket(
        gs, slice(d * n_loc, (d + 1) * n_loc), cam, H, W, D, rows_per_dev, cap)
    recv = coll.all_to_all(send, group)
    vrecv = coll.all_to_all(vsend.to(torch.int32), group) > 0
    band, dropped = _render_received(recv, vrecv, d, rows_per_dev, W, settings, bg)
    full = coll.all_gather(band, group)[:H]
    out = _finalize(full, coll.all_gather(screen.mean2d, group)[:n],
                    coll.all_gather(screen.radius, group)[:n])
    overflow = coll.psum(overflow, group)
    out["exchange_overflow"] = overflow
    out["exchange_bytes"] = torch.tensor(float(D * cap * PAYLOAD_COLS * 4), device=full.device)
    return _dropped_counts(out, coll.psum(dropped, group), overflow)


def rasterize_sharded(means3d, scales, quats, opacities, rgbs, live, cam: Camera,
                      img_shape: Tuple[int, int], bg: torch.Tensor, mesh, axis: str = "tile",
                      settings: RasterizeSettings = RasterizeSettings(),
                      mean2d_offset: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Differentiable render with the image rows sharded over ``mesh[axis]``
    (a ``LocalMesh``), the Gaussians projected once and replicated to every
    band. Returns the dict of ``ops.rasterizer.api.rasterize`` (without
    ``tile_counts``), the image on the Gaussians' device."""
    H, W = int(img_shape[0]), int(img_shape[1])
    D = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    out_dev = means3d.device
    rows_per_dev = _bands(H, settings, D)
    screen = project_gaussians(means3d, scales, quats, opacities, rgbs, live, cam, (H, W),
                               mean2d_offset)
    inputs = (screen.params, screen.color, screen.mean2d, screen.radius, screen.depth,
              screen.in_frustum)
    bands: List[torch.Tensor] = []
    dropped: List[torch.Tensor] = []
    for d, dev in enumerate(devs):
        band, drop = _render_band(*(x.to(dev) for x in inputs), d, rows_per_dev, W, settings,
                                  bg.to(dev), extent=screen.extent.to(dev))
        bands.append(band.to(out_dev))
        dropped.append(drop.to(out_dev))
    out = _finalize(torch.cat(bands)[:H], screen.mean2d, screen.radius)
    return _dropped_counts(out, torch.stack(dropped).sum(0))
