"""Tile binning: assigning depth-ordered Gaussians to image tiles
(counterpart of exavatar_release_tpu/ops/rasterizer/binning.py; the
pair-sort, compact and ragged algorithms, each with the sharded band's
tile-row offset).

``bin_gaussians_sorted`` (also ``bin_gaussians``; the mesh rasterizer bins
its faces with it) gives every Gaussian ``max_tiles_per_gaussian`` pair
lanes. In the compact and ragged algorithms each Gaussian emits its (tile) pairs contiguously at exclusive-cumsum
offsets inside a static pair budget; one stable single-key sort by tile
keeps the global depth order inside every tile. Every integer output
(``order``, ``tile_indices``, ``pair_rank``, ``tid``, ``flags``,
``tile_counts``, ``n_dropped_pairs``) equals the JAX package's on the same
screen-space inputs: the sorts are stable like ``jnp.argsort`` and
``lax.sort``, and ``.at[].max(mode="drop")`` + ``cummax`` becomes a
``scatter_reduce("amax")`` into a buffer with one spill slot + ``cummax``.
Integer work runs in int64; outputs are int32 as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

I64 = torch.int64
I32 = torch.int32


def tile_grid(img_shape: Tuple[int, int], tile_h: int, tile_w: int) -> Tuple[int, int]:
    H, W = img_shape
    return (-(-H // tile_h), -(-W // tile_w))


def _tile_rect(m2d, rad, tile_h, tile_w, ny, nx, extent=None, tile_row_offset=0):
    """CUDA getRect: [lo, hi) tile rectangle covered by each Gaussian.

    ``extent`` (N, 2), when given, replaces the bounding circle with the
    tight per-axis AABB of the alpha >= 1/255 ellipse.

    ``tile_row_offset`` (int): the viewport is the global tile rows
    [offset, offset + ny), a row band of a sharded render. The floors run on
    global pixel coordinates and the offset is subtracted after them, in
    tile-index space, where it is exact: shifting ``m2d`` by the band's
    origin in float32 first rounds differently near tile boundaries and
    flips marginal pairs against the single-device binning."""
    rx = rad if extent is None else extent[:, 0]
    ry = rad if extent is None else extent[:, 1]
    off = float(tile_row_offset)
    x_lo = torch.clamp(torch.floor((m2d[:, 0] - rx) / tile_w), 0, nx).to(I64)
    x_hi = torch.clamp(torch.floor((m2d[:, 0] + rx + tile_w - 1) / tile_w), 0, nx).to(I64)
    y_lo = torch.clamp(torch.floor((m2d[:, 1] - ry) / tile_h) - off, 0, ny).to(I64)
    y_hi = torch.clamp(torch.floor((m2d[:, 1] + ry + tile_h - 1) / tile_h) - off, 0, ny).to(I64)
    return x_lo, x_hi, y_lo, y_hi


def _fill_forward(starts_at: torch.Tensor, vals: torch.Tensor, size: int, init: int) -> torch.Tensor:
    """Scatter ``vals`` (max-combined) at ``starts_at`` into a (size,) buffer
    of ``init``, dropping indices >= size, then forward-fill by cummax."""
    buf = torch.full((size + 1,), init, dtype=I64, device=vals.device)
    buf.scatter_reduce_(0, torch.clamp(starts_at, max=size), vals, reduce="amax")
    return torch.cummax(buf[:size], dim=0).values


def _compact_sorted_pairs(mean2d, radius, depth, visible, img_shape, tile_h, tile_w,
                          max_pairs, extent, tile_row_offset=0):
    """Shared core of the compact/ragged binnings. Returns (order,
    tile_sorted, rank_sorted, starts, counts, total_pairs, ny, nx), all int64,
    with depth order preserved within every tile."""
    n = mean2d.shape[0]
    dev = mean2d.device
    ny, nx = tile_grid(img_shape, tile_h, tile_w)
    num_tiles = ny * nx
    Pm = max_pairs

    sort_key = torch.where(visible, depth, torch.inf)
    order = torch.argsort(sort_key, stable=True)

    m2d = mean2d[order]
    rad = radius[order]
    vis = visible[order] & (rad > 0)
    ext = None if extent is None else extent[order]
    x_lo, x_hi, y_lo, y_hi = _tile_rect(m2d, rad, tile_h, tile_w, ny, nx, ext, tile_row_offset)
    w = x_hi - x_lo
    span = torch.where(vis, w * (y_hi - y_lo), 0)
    offsets = torch.cumsum(span, 0) - span  # exclusive

    # Segment expansion: scatter per-Gaussian values at each segment's first
    # slot and forward-fill. cummax is a fill-forward when the scattered
    # sequence is non-decreasing, forced for the rect fields by packing them
    # under the strictly increasing rank in the high bits. The JAX package
    # packs into int32, so the same bound holds here.
    bny = int(ny).bit_length()
    bw_rank = max(int(n).bit_length(), 1)
    bw_rect = int(nx).bit_length() + bny
    bw_w = int(nx + 1).bit_length()
    assert bw_rank + max(bw_rect, bw_w) <= 31, (n, ny, nx)
    rank = torch.arange(n, dtype=I64, device=dev)
    pack_a = (rank << bw_rect) | (x_lo << bny) | y_lo
    pack_b = (rank << bw_w) | w

    starts_at = torch.where(span > 0, offsets, Pm)  # empty/overflow -> dropped
    a = _fill_forward(starts_at, pack_a, Pm, -1)
    b = _fill_forward(starts_at, pack_b, Pm, -1)
    off_f = _fill_forward(starts_at, offsets, Pm, 0)
    end_f = _fill_forward(starts_at, offsets + span, Pm, 0)

    g_ok = a >= 0
    g = torch.where(g_ok, a >> bw_rect, 0)
    xlo_s = (a >> bny) & ((1 << int(nx).bit_length()) - 1)
    ylo_s = a & ((1 << bny) - 1)
    w_s = torch.clamp(b & ((1 << bw_w) - 1), min=1)

    j = torch.arange(Pm, dtype=I64, device=dev)
    e = j - off_f
    valid = g_ok & (j < end_f)
    ty = ylo_s + torch.div(e, w_s, rounding_mode="floor")
    tx = xlo_s + torch.remainder(e, w_s)
    tile = torch.where(valid, ty * nx + tx, num_tiles)

    # single-key stable sort; depth rank rides along
    tile_sorted, perm = torch.sort(tile, stable=True)
    rank_sorted = torch.where(valid, g, n)[perm]

    starts = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=I64, device=dev)
    )
    counts = starts[1:] - starts[:-1]
    total_pairs = offsets[-1] + span[-1]
    return order, tile_sorted, rank_sorted, starts, counts, total_pairs, ny, nx


def default_max_pairs(n: int, tile_h: int) -> int:
    """The JAX package's pair budget when none is given."""
    return n * max(6, 128 // tile_h)


class TileBinning(NamedTuple):
    order: torch.Tensor  # (N,) int32 Gaussian indices sorted by depth
    tile_indices: torch.Tensor  # (T, K) int32 into the SORTED array; N = sentinel
    tile_counts: torch.Tensor  # (T,) int32 valid entries per tile (uncapped)
    num_tiles: Tuple[int, int]  # (ny, nx)
    n_dropped_pairs: torch.Tensor  # () int32 pairs lost to the pair budget
    n_truncated: torch.Tensor  # () int32 pairs lost to max_per_tile


def _windows(rank_sorted, starts, counts, n: int, max_per_tile: int) -> torch.Tensor:
    """(T, max_per_tile) depth ranks of each tile's first pairs; n past its count."""
    k = torch.arange(max_per_tile, dtype=I64, device=rank_sorted.device)[None, :]
    idx = starts[:-1, None] + k
    rank_pad = torch.cat([rank_sorted, rank_sorted.new_full((1,), n)])
    gathered = rank_pad[torch.clamp(idx, 0, rank_sorted.shape[0])]
    return torch.where(k < counts[:, None], gathered, n)


def bin_gaussians_sorted(mean2d, radius, depth, visible, img_shape, tile_h=8, tile_w=128,
                         max_per_tile=1024, max_tiles_per_gaussian=64,
                         extent=None, tile_row_offset=0) -> TileBinning:
    """Pair-sort binning: each Gaussian emits up to ``max_tiles_per_gaussian``
    (tile, depth-rank) pairs over its screen rectangle, row-major, keeping
    the top-left part of a larger rectangle (``n_dropped_pairs`` counts the
    rest); one stable sort by tile keeps the depth order inside every tile.
    ``tile_row_offset``: the viewport starts at that global tile row (see
    ``_tile_rect``)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    ny, nx = tile_grid(img_shape, tile_h, tile_w)
    num_tiles = ny * nx
    E = max_tiles_per_gaussian

    sort_key = torch.where(visible, depth, torch.inf)
    order = torch.argsort(sort_key, stable=True)
    m2d = mean2d[order]
    rad = radius[order]
    vis = visible[order] & (rad > 0)
    ext = None if extent is None else extent[order]
    x_lo, x_hi, y_lo, y_hi = _tile_rect(m2d, rad, tile_h, tile_w, ny, nx, ext, tile_row_offset)
    w = x_hi - x_lo
    span = w * (y_hi - y_lo)

    e = torch.arange(E, dtype=I64, device=dev)[None, :]
    safe_w = torch.clamp(w, min=1)[:, None]
    ty = y_lo[:, None] + torch.div(e, safe_w, rounding_mode="floor")
    tx = x_lo[:, None] + torch.remainder(e, safe_w)
    valid = vis[:, None] & (e < span[:, None])
    tile_e = torch.where(valid, ty * nx + tx, num_tiles)

    # rows are depth ranks, so a stable sort by tile alone keeps depth order
    tile_sorted, perm = torch.sort(tile_e.reshape(-1), stable=True)
    rank_sorted = torch.div(perm, E, rounding_mode="floor")
    starts = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=I64, device=dev)
    )
    counts = starts[1:] - starts[:-1]
    return TileBinning(
        order=order.to(I32),
        tile_indices=_windows(rank_sorted, starts, counts, n, max_per_tile).to(I32),
        tile_counts=counts.to(I32),
        num_tiles=(ny, nx),
        n_dropped_pairs=torch.sum(torch.where(vis, torch.clamp(span - E, min=0), 0)).to(I32),
        n_truncated=torch.sum(torch.clamp(counts - max_per_tile, min=0)).to(I32),
    )


bin_gaussians = bin_gaussians_sorted


def bin_gaussians_compact(mean2d, radius, depth, visible, img_shape, tile_h=8,
                          tile_w=128, max_per_tile=1024, max_pairs=0,
                          extent=None) -> TileBinning:
    """Compact pair-list binning into dense (T, max_per_tile) windows.

    ``max_pairs`` <= 0 means ``default_max_pairs``. Overflow drops the
    DEEPEST Gaussians' pairs first and is reported in ``n_dropped_pairs``;
    per-tile overflow of ``max_per_tile`` in ``n_truncated``."""
    n = mean2d.shape[0]
    Pm = max_pairs if max_pairs > 0 else default_max_pairs(n, tile_h)
    (order, _, rank_sorted, starts, counts, total_pairs, ny, nx) = _compact_sorted_pairs(
        mean2d, radius, depth, visible, img_shape, tile_h, tile_w, Pm, extent
    )
    return TileBinning(
        order=order.to(I32),
        tile_indices=_windows(rank_sorted, starts, counts, n, max_per_tile).to(I32),
        tile_counts=counts.to(I32),
        num_tiles=(ny, nx),
        n_dropped_pairs=torch.clamp(total_pairs - Pm, min=0).to(I32),
        n_truncated=torch.sum(torch.clamp(counts - max_per_tile, min=0)).to(I32),
    )


class RaggedBinning(NamedTuple):
    """Chunk-aligned pair-major binning. No per-tile capacity exists; the
    only cap is the global pair budget."""

    order: torch.Tensor  # (N,) int32 depth sort
    pair_rank: torch.Tensor  # (Pa,) int32 depth rank per aligned slot; N = pad
    tid: torch.Tensor  # (NC,) int32 tile id per chunk slot
    flags: torch.Tensor  # (NC,) int32 bit0 first / bit1 last / bit2 valid
    tile_counts: torch.Tensor  # (T,) int32
    num_tiles: Tuple[int, int]
    n_dropped_pairs: torch.Tensor  # () int32
    n_truncated: torch.Tensor  # () int32, always 0 (kept for API parity)


def bin_gaussians_ragged(mean2d, radius, depth, visible, img_shape, tile_h=32,
                         tile_w=128, chunk=256, max_pairs=0, extent=None,
                         tile_row_offset=0) -> RaggedBinning:
    """Pair-major binning: the sorted pair list is re-scattered so that every
    tile's window starts on a ``chunk`` boundary (aligned capacity
    max_pairs + T·chunk), with per-chunk-slot tile ids and first/last/valid
    flags. Every tile owns >= 1 slot so empty tiles still emit background.
    ``tile_row_offset``: the viewport starts at that global tile row."""
    n = mean2d.shape[0]
    dev = mean2d.device
    if max_pairs <= 0:
        max_pairs = default_max_pairs(n, tile_h)
    Pm = -(-max_pairs // chunk) * chunk
    (order, tile_sorted, rank_sorted, starts, counts, total_pairs, ny, nx) = _compact_sorted_pairs(
        mean2d, radius, depth, visible, img_shape, tile_h, tile_w, Pm, extent, tile_row_offset
    )
    num_tiles = ny * nx
    Pa = Pm + num_tiles * chunk
    NC = Pa // chunk

    nchunks = torch.clamp(-torch.div(-counts, chunk, rounding_mode="floor"), min=1)
    chunk_starts = torch.cumsum(nchunks, 0) - nchunks
    total_chunks = chunk_starts[-1] + nchunks[-1]

    # scatter each sorted pair to its chunk-aligned slot
    j = torch.arange(Pm, dtype=I64, device=dev)
    pv = tile_sorted < num_tiles
    t_safe = torch.where(pv, tile_sorted, 0)
    dest = torch.where(pv, chunk_starts[t_safe] * chunk + (j - starts[t_safe]), Pa)
    pair_rank = torch.full((Pa + 1,), n, dtype=I64, device=dev)
    pair_rank[dest] = rank_sorted
    pair_rank = pair_rank[:-1]

    # per-chunk-slot metadata via scatter + forward-fill (chunk_starts is
    # strictly increasing since every tile owns >= 1 chunk)
    jc = torch.arange(NC, dtype=I64, device=dev)
    tid = torch.zeros(NC + 1, dtype=I64, device=dev)
    tid[torch.clamp(chunk_starts, max=NC)] = torch.arange(num_tiles, dtype=I64, device=dev)
    tid = torch.cummax(tid[:NC], dim=0).values
    first = jc == chunk_starts[tid]
    last = jc == chunk_starts[tid] + nchunks[tid] - 1
    valid = jc < total_chunks
    flags = first.to(I64) + 2 * (last & valid).to(I64) + 4 * valid.to(I64)
    return RaggedBinning(
        order=order.to(I32),
        pair_rank=pair_rank.to(I32),
        tid=tid.to(I32),
        flags=flags.to(I32),
        tile_counts=counts.to(I32),
        num_tiles=(ny, nx),
        n_dropped_pairs=torch.clamp(total_pairs - Pm, min=0).to(I32),
        n_truncated=torch.zeros((), dtype=I32, device=dev),
    )
