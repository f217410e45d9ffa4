"""Tile compositing: the CUDA kernels' wrappers and their plain PyTorch
versions (counterpart of exavatar_release_tpu/ops/rasterizer/pallas_kernels.py
for ``composite_tiles_fwd_cm`` / ``composite_tiles_bwd_cm``,
``composite_pairs_fwd_rg`` / ``composite_pairs_bwd_rg`` and the row-major
``composite_tiles_fwd_v2`` / ``composite_tiles_bwd_v2`` /
``composite_tiles_fwd`` / ``composite_tiles_bwd``, and of jax_ref.py), and
the measuring kernels of the probe tools (the stage probes of
tools/kvariants.py, the window build of tools/win_probe.py).

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel (``csrc/composite.cu``, ``csrc/composite_bwd.cu``: kernels 1-8
on one body each way, and the stage probes as hooks of the same bodies;
``csrc/windows.cu``), or the wrapper raises. There is no fallback. Each
wrapper counts its launches in ``<wrapper>.launches``.

The backward functions return the cotangent of the rows from the saved
output ``full`` and its cotangent ``g_full``, with renderCUDA's rule
d alpha / d q = exp(q) also where alpha was clamped to 0.99:
  dwin  (T, 12, K)  rows [dA,dB,dC,dgx,dgy,dlog_op,0,0,dr,dg,db,ddepth]
  drows (12, Pa)    the same per pair slot; padding and invalid slots zero

Layouts are the JAX package's:
  win  (T, 12, K)  depth-sorted rows [A,B,C,gx,gy,log_op,0,0,r,g,b,depth]
                   in global pixel coordinates; sentinel rows log_op = -1e9
  rows (12, Pa)    the same rows as a chunk-aligned pair list; chunk slot j
                   holds rows [j*chunk, (j+1)*chunk) of tile tid[j]; flags[j]
                   bit0 first slot of its tile, bit1 last, bit2 valid
  out  (T, 5, P)   [rgb over bg, depth, mask = 1 - T_final], P = th*tw,
                   pixel i of a tile at (i % tw + ox, i // tw + oy)
and for the row-major kernels:
  tile_quad  (T, K, 8)  packed rows [c0..c5, log_op, 0] with q = c0 + c1 lx +
                        c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2 at the tile-local
                        pixel (lx, ly); or, with ``tile_origins`` (T, 2), the
                        global conic rows [A,B,C,gx,gy,log_op,_,_]
  tile_color (T, K, 4)  [r, g, b, depth]
  accum (T, P, 4), tfinal (T, P, 1)  the blend NOT over a background, and
                        the transmittance where each pixel ended
  dquad (T, K, 8), dcolor (T, K, 4)  lanes 6-7 and slots at or past
                        min(count, K) zero; with origins dquad is
                        [dA,dB,dC,dgx,dgy,dlog_op,0,0]
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ... import cuda_build

# renderCUDA's compositing constants
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TERM_EPS = 1e-4


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _scan_forward(q_of, color_of, n: torch.Tensor, T: int, P: int, dev):
    """The blend rules, once for every plain version: a sequential scan over
    each tile's rows [0, n), all tiles and pixels at once. ``q_of(k)`` gives
    (q (T, P), log_op (T, 1), whatever the caller's gradient needs) of row k,
    ``color_of(k)`` its (T, 4) colors. Returns (acc (4, T, P), Tr (T, P),
    visits (T, P)): visits counts the rows each pixel evaluates before it
    terminates, the trigger included."""
    acc = torch.zeros(4, T, P, device=dev)
    Tr = torch.ones(T, P, device=dev)
    done = torch.zeros(T, P, dtype=torch.bool, device=dev)
    visits = torch.zeros(T, P, dtype=torch.int64, device=dev)
    for k in range(int(n.max()) if T else 0):
        live = (k < n)[:, None]
        visits += live & ~done
        q, log_op, _ = q_of(k)
        alpha_un = torch.exp(q)
        valid = (q <= log_op) & (alpha_un >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=ALPHA_MAX), 0.0)
        # sticky termination, excluding the triggering Gaussian
        done = done | (Tr * (1.0 - alpha) < TERM_EPS)
        alpha = torch.where(done, 0.0, alpha)
        w = alpha * Tr
        acc = acc + w[None] * color_of(k).T[:, :, None]
        Tr = Tr * (1.0 - alpha)
    return acc, Tr, visits


def _tile_pixels(T: int, tile_shape, dev, origins=None):
    """Pixel coordinates (T, P) of every tile: tile-local, or global with
    ``origins`` (T, 2)."""
    th, tw = tile_shape
    i = torch.arange(th * tw, device=dev)
    px = (i % tw).float()[None, :].expand(T, -1)
    py = (i // tw).float()[None, :].expand(T, -1)
    if origins is not None:
        px = px + origins[:, 0:1].float()
        py = py + origins[:, 1:2].float()
    return px, py


def _conic_q(row, px, py):
    """q of global conic rows (T, >=6) at pixels (px, py), in the direct
    form: (q, log_op, (A, B, C, dx, dy))."""
    A, B, C = row[:, 0:1], row[:, 1:2], row[:, 2:3]
    dx = px - row[:, 3:4]
    dy = py - row[:, 4:5]
    log_op = row[:, 5:6]
    q = log_op - 0.5 * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy)
    return q, log_op, (A, B, C, dx, dy)


def _packed_q(row, lx, ly):
    """q of packed rows [c0..c5, log_op, 0] at tile-local pixels, summed left
    to right: the order the kernel follows term by term."""
    q = (row[:, 0:1] + row[:, 1:2] * lx + row[:, 2:3] * ly + row[:, 3:4] * (lx * lx)
         + row[:, 4:5] * (lx * ly) + row[:, 5:6] * (ly * ly))
    return q, row[:, 6:7], None


def composite_plain_with_visits(
    win: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor,
    bg: torch.Tensor, tile_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense composite of channel-major windows. Returns (out (T,5,P),
    visits (T,P)): the work the kernel must do."""
    T, _, K = win.shape
    px, py = _tile_pixels(T, tile_shape, win.device, origins)
    n = torch.clamp(counts.long(), max=K)
    acc, Tr, visits = _scan_forward(lambda k: _conic_q(win[:, :, k], px, py),
                                    lambda k: win[:, 8:12, k], n, T, px.shape[1], win.device)
    out = torch.stack(
        [acc[0] + Tr * bg[0], acc[1] + Tr * bg[1], acc[2] + Tr * bg[2], acc[3], 1.0 - Tr],
        dim=1,
    )
    return out, visits


def composite_rm_plain_with_visits(
    tile_quad: torch.Tensor, tile_color: torch.Tensor, tile_counts: torch.Tensor,
    tile_shape: Tuple[int, int], tile_origins: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense composite of row-major rows: (accum (T,P,4), tfinal (T,P,1),
    visits (T,P))."""
    T, K, _ = tile_quad.shape
    px, py = _tile_pixels(T, tile_shape, tile_quad.device, tile_origins)
    n = torch.clamp(tile_counts.long(), max=K)
    q_of = _conic_q if tile_origins is not None else _packed_q
    acc, Tr, visits = _scan_forward(lambda k: q_of(tile_quad[:, k], px, py),
                                    lambda k: tile_color[:, k], n, T, px.shape[1],
                                    tile_quad.device)
    return acc.permute(1, 2, 0).contiguous(), Tr[:, :, None], visits


def composite_tiles_fwd_plain(tile_quad, tile_color, tile_counts, tile_shape,
                              tile_origins=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_fwd``."""
    return composite_rm_plain_with_visits(tile_quad, tile_color, tile_counts, tile_shape,
                                          tile_origins)[:2]


def composite_tiles_fwd_v2_plain(tile_quad, tile_color, tile_counts,
                                 tile_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_fwd_v2``."""
    return composite_tiles_fwd_plain(tile_quad, tile_color, tile_counts, tile_shape)


def composite_tiles_fwd_cm_plain(win, counts, origins, bg, tile_shape) -> torch.Tensor:
    """Plain version of ``composite_tiles_fwd_cm``."""
    return composite_plain_with_visits(win, counts, origins, bg, tile_shape)[0]


def ragged_tile_slots(tid: torch.Tensor, flags: torch.Tensor,
                      num_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each tile's first chunk slot (the slot whose bit0 is set) and its
    number of valid slots (bit2), as int32 (T,) tensors."""
    tid = tid.long()
    valid = (flags & 4) != 0
    first = ((flags & 1) != 0) & valid
    j = torch.arange(tid.shape[0], device=tid.device)
    start = torch.zeros(num_tiles + 1, dtype=torch.int64, device=tid.device)
    start.scatter_(0, torch.where(first, tid, num_tiles), j)
    count = torch.zeros(num_tiles, dtype=torch.int64, device=tid.device)
    count.scatter_add_(0, tid, valid.long())
    return start[:num_tiles].int(), count.int()


def _ragged_as_dense(rows, tid, flags, oy_off: float, tile_shape, num_tiles: int, chunk: int,
                     nx: int):
    """Each tile's slot range gathered into a dense window: (win (T, 12,
    kmax), width (T,), origins (T, 2), idx (T, kmax) pair slots, 0 past the
    width)."""
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    width = count.long() * chunk
    k = torch.arange(int(width.max()) if num_tiles else 0, device=rows.device)
    idx = torch.where(k[None, :] < width[:, None], start.long()[:, None] * chunk + k[None, :], 0)
    win = rows[:, idx].permute(1, 0, 2)  # (T, 12, kmax)
    th, tw = tile_shape
    t = torch.arange(num_tiles, device=rows.device)
    origins = torch.stack([((t % nx) * tw).float(), ((t // nx) * th).float() + oy_off], dim=1)
    return win, width, origins, idx


def composite_pairs_fwd_rg_plain(rows, tid, flags, bg, oy_off: float, tile_shape,
                                 num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Plain version of ``composite_pairs_fwd_rg``: gathers each tile's slot
    range into a dense window and composites it like the dense version."""
    win, width, origins, _ = _ragged_as_dense(rows, tid, flags, oy_off, tile_shape, num_tiles,
                                              chunk, nx)
    return composite_tiles_fwd_cm_plain(win, width, origins, bg, tile_shape)


class BackwardStats(NamedTuple):
    """Work counts of one backward replay, for the kernels' bound."""

    visits: int  # rows evaluated per pixel before termination, trigger included
    hits: int  # (pixel, row) pairs that contribute a gradient


def _replay_backward(q_of, color_of, n: torch.Tensor, g_acc, A_p: torch.Tensor,
                     emit) -> BackwardStats:
    """The backward's replay of ``_scan_forward``, once for every plain
    version. Per pixel, with g_acc the four (T, P) cotangents of accum and
    A_p = g_acc . accum + g_tf tfinal: every live row i with weight w_i =
    alpha_i T_i gets
      cg_i = g_acc . color_i,  P_i = sum_{j<=i} w_j cg_j,
      dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i),  dq_i = dalpha_i exp(q_i)
    (the unclamped d alpha / d q), and ``emit(k, dq, w, extra)`` writes row
    k's gradient from dq (zero where the pixel does not contribute), w and
    what ``q_of`` returned third."""
    T, P = A_p.shape
    dev = A_p.device
    Tr = torch.ones(T, P, device=dev)
    Pr = torch.zeros(T, P, device=dev)
    done = torch.zeros(T, P, dtype=torch.bool, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(int(n.max()) if T else 0):
        live = (k < n)[:, None]
        visits += (live & ~done).sum()
        q, log_op, extra = q_of(k)
        alpha_un = torch.exp(q)
        valid = (q <= log_op) & (alpha_un >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=ALPHA_MAX), 0.0)
        done = done | (Tr * (1.0 - alpha) < TERM_EPS)
        hit = valid & ~done
        hits += hit.sum()
        alpha = torch.where(done, 0.0, alpha)
        w = alpha * Tr
        col = color_of(k)
        cg = (g_acc[0] * col[:, 0:1] + g_acc[1] * col[:, 1:2] + g_acc[2] * col[:, 2:3]
              + g_acc[3] * col[:, 3:4])
        Pr = Pr + w * cg
        dalpha = Tr * cg - (A_p - Pr) / (1.0 - alpha)
        dq = torch.where(hit, dalpha * alpha_un, 0.0)  # unclamped d alpha / d q
        emit(k, dq, w, extra)
        Tr = Tr * (1.0 - alpha)
    return BackwardStats(int(visits), int(hits))


def _conic_row_grad(dq: torch.Tensor, extra) -> torch.Tensor:
    """(T, 6) gradient [dA, dB, dC, dgx, dgy, dlog_op] of a global conic row
    from its pixels' dq (T, P) and what ``_conic_q`` returned third."""
    A, B, C, dx, dy = extra
    return torch.stack([
        (-0.5 * (dx * dx) * dq).sum(1), (-(dx * dy) * dq).sum(1), (-0.5 * (dy * dy) * dq).sum(1),
        ((A * dx + B * dy) * dq).sum(1), ((B * dx + C * dy) * dq).sum(1), dq.sum(1)], dim=1)


def composite_bwd_plain_with_stats(
    win: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor, bg: torch.Tensor,
    full: torch.Tensor, g_full: torch.Tensor, tile_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, BackwardStats]:
    """Dense backward of channel-major windows as an explicit replay of the
    forward scan. Per pixel g_acc = g_full[0:4], tfinal = 1 - full[4], g_tf =
    bg . g_full[0:3] - g_full[4]; a row's gradient is the sum over the tile's
    pixels of dq times dq/d(row), and of w g_acc for the colors. Returns
    (dwin, stats)."""
    T, _, K = win.shape
    px, py = _tile_pixels(T, tile_shape, win.device, origins)
    n = torch.clamp(counts.long(), max=K)
    tfinal = 1.0 - full[:, 4]
    g_acc = [g_full[:, c] for c in range(4)]
    g_tf = bg[0] * g_full[:, 0] + bg[1] * g_full[:, 1] + bg[2] * g_full[:, 2] - g_full[:, 4]
    A_p = (g_acc[0] * (full[:, 0] - bg[0] * tfinal) + g_acc[1] * (full[:, 1] - bg[1] * tfinal)
           + g_acc[2] * (full[:, 2] - bg[2] * tfinal) + g_acc[3] * full[:, 3] + g_tf * tfinal)
    dwin = torch.zeros(T, 12, K, device=win.device)

    def emit(k, dq, w, extra):
        dwin[:, 0:6, k] = _conic_row_grad(dq, extra)
        for c in range(4):
            dwin[:, 8 + c, k] = (w * g_acc[c]).sum(1)

    stats = _replay_backward(lambda k: _conic_q(win[:, :, k], px, py),
                             lambda k: win[:, 8:12, k], n, g_acc, A_p, emit)
    return dwin, stats


def composite_rm_bwd_plain_with_stats(
    tile_quad: torch.Tensor, tile_color: torch.Tensor, tile_counts: torch.Tensor,
    g_accum: torch.Tensor, g_tfinal: torch.Tensor, accum: torch.Tensor, tfinal: torch.Tensor,
    tile_shape: Tuple[int, int], tile_origins: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, BackwardStats]:
    """Dense backward of row-major rows: (dquad (T,K,8), dcolor (T,K,4),
    stats). A_p is formed from both cotangents. For packed rows the
    coefficient gradient is the sum over pixels of dq times the tile-local
    basis [1, lx, ly, lx^2, lx ly, ly^2]; with origins it is the gradient of
    the global conic row, each pixel's term taken directly from its offset to
    the center (the packing's transpose applied to the summed basis form is
    the same in exact arithmetic, but cancels large terms in float32)."""
    T, K, _ = tile_quad.shape
    dev = tile_quad.device
    px, py = _tile_pixels(T, tile_shape, dev, tile_origins)
    n = torch.clamp(tile_counts.long(), max=K)
    g_acc = [g_accum[:, :, c] for c in range(4)]
    A_p = (g_acc[0] * accum[:, :, 0] + g_acc[1] * accum[:, :, 1] + g_acc[2] * accum[:, :, 2]
           + g_acc[3] * accum[:, :, 3] + g_tfinal[:, :, 0] * tfinal[:, :, 0])
    dquad = torch.zeros(T, K, 8, device=dev)
    dcolor = torch.zeros(T, K, 4, device=dev)
    basis = (None, px, py, px * px, px * py, py * py)

    def emit(k, dq, w, extra):
        if extra is not None:
            dquad[:, k, 0:6] = _conic_row_grad(dq, extra)
        else:
            dquad[:, k, 0] = dq.sum(1)
            for c in range(1, 6):
                dquad[:, k, c] = (dq * basis[c]).sum(1)
        for c in range(4):
            dcolor[:, k, c] = (w * g_acc[c]).sum(1)

    q_of = _conic_q if tile_origins is not None else _packed_q
    stats = _replay_backward(lambda k: q_of(tile_quad[:, k], px, py),
                             lambda k: tile_color[:, k], n, g_acc, A_p, emit)
    return dquad, dcolor, stats


def composite_tiles_bwd_plain(tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum,
                              tfinal, tile_shape,
                              tile_origins=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_bwd``."""
    return composite_rm_bwd_plain_with_stats(tile_quad, tile_color, tile_counts, g_accum,
                                             g_tfinal, accum, tfinal, tile_shape,
                                             tile_origins)[:2]


def composite_tiles_bwd_v2_plain(tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum,
                                 tfinal, tile_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_bwd_v2``."""
    return composite_tiles_bwd_plain(tile_quad, tile_color, tile_counts, g_accum, g_tfinal,
                                     accum, tfinal, tile_shape)


def composite_tiles_bwd_cm_plain(win, counts, origins, bg, full, g_full,
                                 tile_shape) -> torch.Tensor:
    """Plain version of ``composite_tiles_bwd_cm``."""
    return composite_bwd_plain_with_stats(win, counts, origins, bg, full, g_full, tile_shape)[0]


def composite_pairs_bwd_rg_plain(rows, tid, flags, bg, oy_off: float, full, g_full, tile_shape,
                                 num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Plain version of ``composite_pairs_bwd_rg``: the dense replay on each
    tile's gathered slot range, scattered back to the pair slots."""
    win, width, origins, idx = _ragged_as_dense(rows, tid, flags, oy_off, tile_shape, num_tiles,
                                                chunk, nx)
    dwin = composite_tiles_bwd_cm_plain(win, width, origins, bg, full, g_full, tile_shape)
    inside = torch.arange(idx.shape[1], device=rows.device)[None, :] < width[:, None]
    drows = torch.zeros_like(rows)
    drows[:, idx[inside]] = dwin.permute(1, 0, 2)[:, inside]
    return drows


# --------------------------------------------------------------------------
# the pair bodies' cull and exp gate (kernels 1-8), in Python for
# the tests and chip_smoke.py (no kernel path calls these)
# --------------------------------------------------------------------------

# composite_common.cuh's kQGate: q below it skips without an exp, since
# exp(Q_GATE) < 1/255 in float32
Q_GATE = -5.55
# pixel_box's constants, as composite_common.cuh rounds them to float32
BOX_LN255 = 5.5413  # above ln 255 = 5.541264
BOX_MAX_K = 1e5
BOX_SLACK_K = 1e-5
BOX_SLACK_ABS = 1e-5
BOX_REL = 1.0 + 1.0 / 1024.0
BOX_PAD = 1.0
# packed_pixel_box's slack per unit of the terms' magnitudes
BOX_PACK_SLACK = 4e-6


def row_pixel_box(rows: torch.Tensor) -> torch.Tensor:
    """The conservative pixel box of each row that composite_common.cuh's
    ``pixel_box`` stages beside it, operation for operation in float32: rows
    (12, ...) channel-major -> (4, ...) [xmin, xmax, ymin, ymax] in global
    pixel coordinates.

    A pixel composites a row only where alpha = exp(q) >= 1/255, i.e. where
    0.5 d^T Q d <= L = log_op + ln 255 with Q = [[A, B], [B, C]] and d the
    pixel's offset from (gx, gy). For Q positive definite that is an ellipse
    of half-extents sqrt(2 L Sxx) and sqrt(2 L Syy), where S = Q^-1: Sxx = C /
    det, Syy = A / det, det = AC - B^2 (the ellipse preprocess.py bins on).
    The kernel's q is float32: its error is a few ulps of |log_op| + A dx^2 +
    C dy^2 + |B dx dy|, and at the ellipse's edge those terms reach about 2 L
    k, k = AC / det = 1 / (1 - rho^2). So L is widened to L (1 + 1e-5 k) +
    1e-5 (1 + |log_op|), the extents by 1/1024 and one pixel; ln 255 is
    taken as 5.5413, above the float32 threshold's own logarithm. The box is
    empty (xmin > xmax) when L < 0, which includes the -1e9 padding rows, and
    the whole plane (infinite) when det <= 0, k >= 1e5 (the float32 det is
    then too inexact to trust) or an extent is not finite: there the kernel's
    per-pixel test decides alone."""
    A, B, C, gx, gy, log_op = (rows[c].float() for c in range(6))
    inf = torch.full_like(A, math.inf)
    L = log_op + BOX_LN255
    det = A * C - B * B
    k = (A * C) / det
    Lb = L * (1.0 + BOX_SLACK_K * k) + BOX_SLACK_ABS * (1.0 + log_op.abs())
    ex = torch.sqrt(2.0 * Lb * (C / det)) * BOX_REL + BOX_PAD
    ey = torch.sqrt(2.0 * Lb * (A / det)) * BOX_REL + BOX_PAD
    box = torch.stack([gx - ex, gx + ex, gy - ey, gy + ey])
    whole = ~(det > 0) | ~(k < BOX_MAX_K) | ~torch.isfinite(ex) | ~torch.isfinite(ey)
    box = torch.where(whole, torch.stack([-inf, inf, -inf, inf]), box)
    return torch.where(L < 0, torch.stack([inf, -inf, inf, -inf]), box)


def packed_row_pixel_box(quad: torch.Tensor, tile_shape) -> torch.Tensor:
    """The conservative pixel box of each packed row that
    composite_common.cuh's ``packed_pixel_box`` stages beside it for a th x tw
    tile, operation for operation in float32: quad (..., 8) [c0..c5, log_op,
    0] -> (4, ...) [xmin, xmax, ymin, ymax] in tile-local pixel coordinates.

    The kernel evaluates q = c0 + c1 lx + c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2
    left to right in float32 at the tile's pixels, lx in [0, tw - 1], ly in
    [0, th - 1]; a pixel composites only where that q >= -5.5413 (the 1/255
    floor, as in ``row_pixel_box``) and q <= log_op. The box bounds these
    coefficients' own quadratic, not the conic they were packed from:

    * The conic is exact in them: A = -2 c3, B = -c4, C = -2 c5 (a sign and a
      power of two), so q = q* - 0.5 (l - m)^T Q (l - m) with Q = [[A, B], [B,
      C]], the center m = Q^-1 (c1, c2) and the peak q* = c0 + (c1 mx + c2
      my) / 2, in exact arithmetic on the float32 coefficients.
    * Each of q's five sums and three products rounds once, so at a pixel the
      float32 q is within 6 u (u = 2^-24) of the exact one times the sum of
      its terms' magnitudes, at most ``far`` = |c0| + |c1| (tw-1) + |c2|
      (th-1) + |c3| (tw-1)^2 + |c4| (tw-1)(th-1) + |c5| (th-1)^2 anywhere in the
      tile. |c0| dominates it when the mean lies far from the tile's origin:
      c0 holds -0.5 A gx^2 at the tile-local gx.
    * m is computed with one reciprocal, inv = 1 / det (seven divisions
      cost kernel 3 six registers and 15% of its time on an H100, PERF.md):
      its float32 error is at most about 3 u (|C c1| + |B c2|) / det + 3 u k
      |m| (k = AC / det; det itself is good to (2k + 1) u relative, inv and
      the product add a rounding each), dmx below with a slack of 4e-6 = 67
      u per unit in place of 3 u; q*'s error about 3 u ``peak`` (= |c0| +
      |c1 mx| + |c2 my|) plus (|c1| dmx + |c2| dmy) / 2.
    * So a pixel that composites lies in 0.5 (l - m)^T Q (l - m) <= Lb = q* +
      ln 255 + 1e-5 + 4e-6 (far + peak) + (|c1| dmx + |c2| dmy) / 2, whose
      extents from m are sqrt(2 Lb Sxx) and sqrt(2 Lb Syy) (Sxx = C / det,
      Syy = A / det). Lb is widened by (1 + 1e-5 k) for the rounding of
      C inv and A inv, the extents by 1/1024, one pixel and m's error.

    4e-6 is 11 times the 6 u that q's rounding needs and 22 times the 3 u of
    m's. The box is empty when log_op + ln 255 < 0 (no float32 q passes both
    q <= log_op and the floor: the -1e9 padding rows) or when Lb < 0; the
    whole plane (infinite), left to the per-pixel test, when Q is not
    positive definite (A <= 0 or det <= 0: q* is then no peak), k >= 1e5,
    or Lb, m's error or an extent is not finite. Pixels outside the tile are
    never evaluated and the box says nothing about them."""
    th, tw = tile_shape
    c0, c1, c2, c3, c4, c5, log_op = (quad[..., c].float() for c in range(7))
    inf = torch.full_like(c0, math.inf)
    A, B, C = -2.0 * c3, -c4, -2.0 * c5
    det = A * C - B * B
    inv = 1.0 / det
    k = (A * C) * inv
    mx = (C * c1 - B * c2) * inv
    my = (A * c2 - B * c1) * inv
    dmx = BOX_PACK_SLACK * (((C * c1).abs() + (B * c2).abs()) * inv + k * mx.abs())
    dmy = BOX_PACK_SLACK * (((A * c2).abs() + (B * c1).abs()) * inv + k * my.abs())
    qs = c0 + 0.5 * (c1 * mx + c2 * my)
    fx, fy = float(tw - 1), float(th - 1)
    far = (c0.abs() + c1.abs() * fx + c2.abs() * fy + c3.abs() * (fx * fx)
           + c4.abs() * (fx * fy) + c5.abs() * (fy * fy))
    peak = c0.abs() + (c1 * mx).abs() + (c2 * my).abs()
    Lb = (qs + BOX_LN255 + BOX_SLACK_ABS + BOX_PACK_SLACK * (far + peak)
          + 0.5 * (c1.abs() * dmx + c2.abs() * dmy))
    Lk = Lb * (1.0 + BOX_SLACK_K * k)
    ex = torch.sqrt(2.0 * Lk * (C * inv)) * BOX_REL + BOX_PAD + dmx
    ey = torch.sqrt(2.0 * Lk * (A * inv)) * BOX_REL + BOX_PAD + dmy
    box = torch.stack([mx - ex, mx + ex, my - ey, my + ey])
    whole = torch.stack([-inf, inf, -inf, inf])
    empty = torch.stack([inf, -inf, inf, -inf])
    box = torch.where(~torch.isfinite(ex) | ~torch.isfinite(ey), whole, box)
    box = torch.where(Lb < 0, empty, box)
    give_up = (~(A > 0) | ~(det > 0) | ~(k < BOX_MAX_K) | ~torch.isfinite(Lb)
               | ~torch.isfinite(dmx) | ~torch.isfinite(dmy))
    box = torch.where(give_up, whole, box)
    return torch.where(log_op + BOX_LN255 < 0, empty, box)


def bwd_row_errors(got: torch.Tensor, want: torch.Tensor,
                   row_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A backward output against a reference, row by row: (max |got - want|,
    max |want|), one value per index of ``row_dim``. The rows carry different units (dA, dB and dC
    scale with squared pixel distances, dlog_op and the colors with none), so
    a difference is judged against its own row's largest value, never
    against the whole tensor's: that would hide a wrong color row behind the
    conic rows."""
    other = [d for d in range(want.dim()) if d != row_dim % want.dim()]
    return (got - want).abs().amax(other), want.abs().amax(other)


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


# argtypes of the row-major entry points with origins (kernels 5 and 6, and
# their stage probes after the variant): quad, color, counts, origins, then
# accum, tfinal (forward) or g_accum, g_tfinal, accum, tfinal, dquad, dcolor
# (backward), T, K, th, tw, stream
_RM_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_RM_BWD_ARGS = [_P] * 10 + [_I] * 4 + [_P]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("composite")
    lib.composite_tiles_fwd_cm.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.composite_pairs_fwd_rg.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P,
    ]
    lib.composite_tiles_fwd_v2.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.composite_tiles_fwd.argtypes = _RM_FWD_ARGS
    lib.composite_rm_fwd_variant.argtypes = [_I] + _RM_FWD_ARGS
    for fn in (lib.composite_tiles_fwd_cm, lib.composite_pairs_fwd_rg, lib.composite_tiles_fwd_v2,
               lib.composite_tiles_fwd, lib.composite_rm_fwd_variant):
        fn.restype = _I
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = cuda_build.load("composite_bwd")
    lib.composite_tiles_bwd_cm.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.composite_pairs_bwd_rg.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P,
    ]
    lib.composite_tiles_bwd_v2.argtypes = [_P] * 9 + [_I, _I, _I, _I, _P]
    lib.composite_tiles_bwd.argtypes = _RM_BWD_ARGS
    lib.composite_rm_bwd_variant.argtypes = [_I] + _RM_BWD_ARGS
    for fn in (lib.composite_tiles_bwd_cm, lib.composite_pairs_bwd_rg, lib.composite_tiles_bwd_v2,
               lib.composite_tiles_bwd, lib.composite_rm_bwd_variant):
        fn.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {x.device}")
    return False


def composite_tiles_fwd_cm(win, counts, origins, bg, tile_shape) -> torch.Tensor:
    """Dense composite. win (T, 12, K) f32, counts (T,) i32, origins (T, 2)
    f32, bg (3,) f32 -> (T, 5, th*tw). Replaces
    pallas_kernels.composite_tiles_fwd_cm (its ``chunk``/``sub`` were TPU
    tiling knobs and do not change the result)."""
    if _on_cpu(win):
        return composite_tiles_fwd_cm_plain(win, counts, origins, bg, tile_shape)
    T, _, K = win.shape
    th, tw = tile_shape
    dev = win.device
    _check("win", win, torch.float32, (T, 12, K), dev)
    _check("counts", counts, torch.int32, (T,), dev)
    _check("origins", origins, torch.float32, (T, 2), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    out = torch.empty(T, 5, th * tw, device=dev)
    if T == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().composite_tiles_fwd_cm(
            win.data_ptr(), counts.data_ptr(), origins.data_ptr(), bg.data_ptr(),
            out.data_ptr(), T, K, th, tw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_tiles_fwd_cm")
    composite_tiles_fwd_cm.launches += 1
    return out


composite_tiles_fwd_cm.launches = 0


def composite_pairs_fwd_rg(rows, tid, flags, bg, oy_off: float, tile_shape,
                           num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Ragged pair-major composite. rows (12, Pa) f32, tid/flags (NC,) i32,
    bg (3,) f32, oy_off the global row of tile row 0 -> (T, 5, th*tw).
    Every tile emits background, also a tile without pairs. Replaces
    pallas_kernels.composite_pairs_fwd_rg."""
    if _on_cpu(rows):
        return composite_pairs_fwd_rg_plain(
            rows, tid, flags, bg, oy_off, tile_shape, num_tiles, chunk, nx
        )
    NC = tid.shape[0]
    th, tw = tile_shape
    dev = rows.device
    _check("rows", rows, torch.float32, (12, NC * chunk), dev)
    _check("tid", tid, torch.int32, (NC,), dev)
    _check("flags", flags, torch.int32, (NC,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    out = torch.empty(num_tiles, 5, th * tw, device=dev)
    if num_tiles == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().composite_pairs_fwd_rg(
            rows.data_ptr(), start.data_ptr(), count.data_ptr(), bg.data_ptr(),
            float(oy_off), out.data_ptr(), num_tiles, NC * chunk, chunk, th, tw, nx,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_pairs_fwd_rg")
    composite_pairs_fwd_rg.launches += 1
    return out


composite_pairs_fwd_rg.launches = 0


def composite_tiles_bwd_cm(win, counts, origins, bg, full, g_full, tile_shape) -> torch.Tensor:
    """Backward of the dense composite w.r.t. ``win``. full, g_full (T, 5,
    th*tw) f32: the forward's output and its cotangent -> dwin (T, 12, K).
    Replaces pallas_kernels.composite_tiles_bwd_cm."""
    if _on_cpu(win):
        return composite_tiles_bwd_cm_plain(win, counts, origins, bg, full, g_full, tile_shape)
    T, _, K = win.shape
    th, tw = tile_shape
    dev = win.device
    _check("win", win, torch.float32, (T, 12, K), dev)
    _check("counts", counts, torch.int32, (T,), dev)
    _check("origins", origins, torch.float32, (T, 2), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    _check("full", full, torch.float32, (T, 5, th * tw), dev)
    _check("g_full", g_full, torch.float32, (T, 5, th * tw), dev)
    # the kernel adds its blocks' partial sums into dwin with atomics
    dwin = torch.zeros(T, 12, K, device=dev)
    if T == 0 or K == 0:
        return dwin
    with torch.cuda.device(dev):
        rc = _lib_bwd().composite_tiles_bwd_cm(
            win.data_ptr(), counts.data_ptr(), origins.data_ptr(), bg.data_ptr(),
            full.data_ptr(), g_full.data_ptr(), dwin.data_ptr(), T, K, th, tw,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_tiles_bwd_cm")
    composite_tiles_bwd_cm.launches += 1
    return dwin


composite_tiles_bwd_cm.launches = 0


def composite_pairs_bwd_rg(rows, tid, flags, bg, oy_off: float, full, g_full, tile_shape,
                           num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Backward of the ragged composite w.r.t. ``rows`` -> drows (12, Pa);
    sentinel rows and slots without the valid bit get exact zeros. Replaces
    pallas_kernels.composite_pairs_bwd_rg."""
    if _on_cpu(rows):
        return composite_pairs_bwd_rg_plain(
            rows, tid, flags, bg, oy_off, full, g_full, tile_shape, num_tiles, chunk, nx
        )
    NC = tid.shape[0]
    th, tw = tile_shape
    dev = rows.device
    _check("rows", rows, torch.float32, (12, NC * chunk), dev)
    _check("tid", tid, torch.int32, (NC,), dev)
    _check("flags", flags, torch.int32, (NC,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    _check("full", full, torch.float32, (num_tiles, 5, th * tw), dev)
    _check("g_full", g_full, torch.float32, (num_tiles, 5, th * tw), dev)
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    drows = torch.zeros_like(rows)
    if num_tiles == 0 or NC == 0:
        return drows
    with torch.cuda.device(dev):
        rc = _lib_bwd().composite_pairs_bwd_rg(
            rows.data_ptr(), start.data_ptr(), count.data_ptr(), bg.data_ptr(), float(oy_off),
            full.data_ptr(), g_full.data_ptr(), drows.data_ptr(), num_tiles, NC * chunk, chunk,
            th, tw, nx, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_pairs_bwd_rg")
    composite_pairs_bwd_rg.launches += 1
    return drows


composite_pairs_bwd_rg.launches = 0


# --------------------------------------------------------------------------
# row-major kernels: kernel_v=2 (3, 4), 5, 6 and the stage probes of 5 and 6,
# all on the pair bodies of csrc/composite.cu and csrc/composite_bwd.cu
# --------------------------------------------------------------------------


def _check_rm(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    """A float32 operand of the row-major kernels, which load and store
    16 bytes at a time."""
    _check(name, x, torch.float32, shape, device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _fwd_rm(wrapper, tile_quad, tile_color, tile_counts, tile_shape, tile_origins,
            variant: Optional[int] = None):
    """Checks, allocation and launch shared by the forward wrappers;
    ``wrapper`` is the one whose kernel and launch count are used, and
    ``variant`` the stage probe's number for ``composite_tiles_fwd_variant``."""
    T, K, _ = tile_quad.shape
    th, tw = tile_shape
    dev = tile_quad.device
    _check_rm("tile_quad", tile_quad, (T, K, 8), dev)
    _check_rm("tile_color", tile_color, (T, K, 4), dev)
    _check("tile_counts", tile_counts, torch.int32, (T,), dev)
    if tile_origins is not None:
        _check("tile_origins", tile_origins, torch.float32, (T, 2), dev)
    accum = torch.empty(T, th * tw, 4, device=dev)
    tfinal = torch.empty(T, th * tw, 1, device=dev)
    if T == 0:
        return accum, tfinal
    head = (tile_quad.data_ptr(), tile_color.data_ptr(), tile_counts.data_ptr())
    tail = (accum.data_ptr(), tfinal.data_ptr(), T, K, th, tw,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        origins = None if tile_origins is None else tile_origins.data_ptr()
        if wrapper is composite_tiles_fwd_v2:
            rc = _lib().composite_tiles_fwd_v2(*head, *tail)
        elif variant is not None:
            rc = _lib().composite_rm_fwd_variant(variant, *head, origins, *tail)
        else:
            rc = _lib().composite_tiles_fwd(*head, origins, *tail)
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    return accum, tfinal


def _bwd_rm(wrapper, tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal,
            tile_shape, tile_origins, variant: Optional[int] = None):
    """Checks, allocation and launch shared by the backward wrappers."""
    T, K, _ = tile_quad.shape
    th, tw = tile_shape
    P = th * tw
    dev = tile_quad.device
    _check_rm("tile_quad", tile_quad, (T, K, 8), dev)
    _check_rm("tile_color", tile_color, (T, K, 4), dev)
    _check("tile_counts", tile_counts, torch.int32, (T,), dev)
    if tile_origins is not None:
        _check("tile_origins", tile_origins, torch.float32, (T, 2), dev)
    _check_rm("g_accum", g_accum, (T, P, 4), dev)
    _check_rm("g_tfinal", g_tfinal, (T, P, 1), dev)
    _check_rm("accum", accum, (T, P, 4), dev)
    _check_rm("tfinal", tfinal, (T, P, 1), dev)
    # the kernel adds its blocks' partial sums to live rows with atomics; the
    # TPU v2 kernel left dead regions unwritten, here they are zero
    dquad = torch.zeros(T, K, 8, device=dev)
    dcolor = torch.zeros(T, K, 4, device=dev)
    if T == 0 or K == 0:
        return dquad, dcolor
    head = (tile_quad.data_ptr(), tile_color.data_ptr(), tile_counts.data_ptr())
    tail = (g_accum.data_ptr(), g_tfinal.data_ptr(), accum.data_ptr(), tfinal.data_ptr(),
            dquad.data_ptr(), dcolor.data_ptr(), T, K, th, tw,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        origins = None if tile_origins is None else tile_origins.data_ptr()
        if wrapper is composite_tiles_bwd_v2:
            rc = _lib_bwd().composite_tiles_bwd_v2(*head, *tail)
        elif variant is not None:
            rc = _lib_bwd().composite_rm_bwd_variant(variant, *head, origins, *tail)
        else:
            rc = _lib_bwd().composite_tiles_bwd(*head, origins, *tail)
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    return dquad, dcolor


def composite_tiles_fwd_v2(tile_quad, tile_color, tile_counts,
                           tile_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense row-major composite of packed rows. tile_quad (T, K, 8),
    tile_color (T, K, 4) f32, tile_counts (T,) i32 -> accum (T, th*tw, 4),
    tfinal (T, th*tw, 1). Replaces pallas_kernels.composite_tiles_fwd_v2 (its
    ``chunk`` and ``prefix_bf16`` were TPU tiling and matrix-unit knobs)."""
    if _on_cpu(tile_quad):
        return composite_tiles_fwd_v2_plain(tile_quad, tile_color, tile_counts, tile_shape)
    return _fwd_rm(composite_tiles_fwd_v2, tile_quad, tile_color, tile_counts, tile_shape, None)


composite_tiles_fwd_v2.launches = 0


def composite_tiles_fwd(tile_quad, tile_color, tile_counts, tile_shape,
                        tile_origins=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function; with ``tile_origins`` (T, 2) f32 the rows of
    tile_quad are global conic rows and q is the direct form of the
    channel-major kernels (kernel 5; without origins kernel 3's body runs,
    counted here). Replaces pallas_kernels.composite_tiles_fwd."""
    if _on_cpu(tile_quad):
        return composite_tiles_fwd_plain(tile_quad, tile_color, tile_counts, tile_shape,
                                         tile_origins)
    return _fwd_rm(composite_tiles_fwd, tile_quad, tile_color, tile_counts, tile_shape,
                   tile_origins)


composite_tiles_fwd.launches = 0


def composite_tiles_bwd_v2(tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal,
                           tile_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``composite_tiles_fwd_v2`` from both cotangents and the
    forward's own outputs -> dquad (T, K, 8), dcolor (T, K, 4). Replaces
    pallas_kernels.composite_tiles_bwd_v2."""
    if _on_cpu(tile_quad):
        return composite_tiles_bwd_v2_plain(tile_quad, tile_color, tile_counts, g_accum,
                                            g_tfinal, accum, tfinal, tile_shape)
    return _bwd_rm(composite_tiles_bwd_v2, tile_quad, tile_color, tile_counts, g_accum, g_tfinal,
                   accum, tfinal, tile_shape, None)


composite_tiles_bwd_v2.launches = 0


def composite_tiles_bwd(tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal,
                        tile_shape, tile_origins=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``composite_tiles_fwd``; with ``tile_origins`` dquad comes
    in the global row layout (kernel 6; without origins kernel 4's body runs,
    counted here). Replaces pallas_kernels.composite_tiles_bwd."""
    if _on_cpu(tile_quad):
        return composite_tiles_bwd_plain(tile_quad, tile_color, tile_counts, g_accum, g_tfinal,
                                         accum, tfinal, tile_shape, tile_origins)
    return _bwd_rm(composite_tiles_bwd, tile_quad, tile_color, tile_counts, g_accum, g_tfinal,
                   accum, tfinal, tile_shape, tile_origins)


composite_tiles_bwd.launches = 0


# --------------------------------------------------------------------------
# stage probes: kernels 5 and 6 (composite_tiles_fwd / _bwd with origins) with
# one stage of their pair body stubbed or reformulated, each variant a
# compile-time instantiation of the body's `if constexpr` hooks (replace
# tools/kvariants.py:build_fwd and build_bwd). ``base`` is kernel 5's / 6's
# own code, launched and counted as a probe. The variants, their meaning on
# the pair body and what each isolates are described in
# csrc/composite_probes.cuh.
# --------------------------------------------------------------------------

FWD_VARIANTS = ("base", "noexp", "nomm", "noskip", "logsp", "pipe", "chunk")
BWD_VARIANTS = ("base", "noexp", "nomm", "nograd", "fusedgrad", "noT", "nodeloc", "logsp",
                "noT+logsp", "pipe", "chunk")
# the kernels' enum Variant
VARIANT_IDS = {"base": 0, "noexp": 1, "nomm": 2, "noskip": 3, "logsp": 4, "pipe": 5, "nograd": 6,
               "fusedgrad": 7, "noT": 8, "nodeloc": 9, "noT+logsp": 10, "chunk": 11}
# variants whose output is base's, up to rounding; the others are stubs
EXACT_VARIANTS = ("noskip", "logsp", "pipe", "fusedgrad", "noT", "noT+logsp", "chunk")
PROBE_CHUNK = 256  # the stubs' chunk: one staging batch of the kernels
# log(0.99) and log(1e-4): the log-space clamp and termination test
LN_ALPHA_MAX = -0.01005033585350145
LN_TERM_EPS = -9.210340371976182


def _variant_id(variant: str, allowed) -> int:
    if variant not in allowed:
        raise ValueError(f"unknown variant {variant!r}; one of {allowed}")
    return VARIANT_IDS[variant]


def _probe_fns(variant: str):
    """(E, L): exp and log1p, or the noexp stub's 0.25 x + 1 and 0.5 x."""
    if variant == "noexp":
        return (lambda x: x * 0.25 + 1.0), (lambda x: x * 0.5)
    return torch.exp, torch.log1p


def _chunk_end(k: int, n: torch.Tensor) -> torch.Tensor:
    """(T, 1): row k closes its tile's chunk (a full staging batch, or the
    tile's last row)."""
    return (((k + 1) % PROBE_CHUNK == 0) | (k + 1 == n))[:, None]


def composite_tiles_fwd_variant_plain_with_visits(
    variant, tile_quad, tile_color, tile_counts, tile_shape, tile_origins,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_fwd_variant``, a scan over each
    tile's rows in the kernel's order, with the rows the kernel evaluates
    at each pixel: (accum, tfinal, visits (T, P)). A stub can change how
    early pixels end, and so the work: base, pipe and logsp evaluate rows up
    to the one that ends the pixel, noskip every row, the chunked variants
    every row of each chunk the pixel starts alive. noskip and pipe change
    only how the kernel walks the rows: their output is base's."""
    _variant_id(variant, FWD_VARIANTS)
    if variant in ("base", "noskip", "pipe"):
        acc, tf, visits = composite_rm_plain_with_visits(tile_quad, tile_color, tile_counts,
                                                         tile_shape, tile_origins)
        if variant == "noskip":
            n = torch.clamp(tile_counts.long(), max=tile_quad.shape[1])
            visits = n[:, None].expand_as(visits).contiguous()
        return acc, tf, visits
    T, K, _ = tile_quad.shape
    dev = tile_quad.device
    px, py = _tile_pixels(T, tile_shape, dev, tile_origins)
    n = torch.clamp(tile_counts.long(), max=K)
    E, L = _probe_fns(variant)
    logsp = variant == "logsp"
    acc = torch.zeros(4, T, px.shape[1], device=dev)
    Tr = torch.full_like(px, 0.0 if logsp else 1.0)  # logsp: log T; chunked: T0
    done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
    cum, kept, dead = torch.zeros_like(px), torch.zeros_like(px), torch.zeros_like(done)
    visits = torch.zeros(px.shape, dtype=torch.int64, device=dev)
    for k in range(int(n.max()) if T else 0):
        live = (k < n)[:, None]
        visits += live & ~done
        q, log_op, _ = _conic_q(tile_quad[:, k], px, py)
        e = E(q)
        valid = (q <= log_op) & (e >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(e, max=ALPHA_MAX), 0.0)
        color = tile_color[:, k].T[:, :, None]
        if logsp:
            wl = torch.log1p(-alpha)
            done = done | (valid & (Tr + wl < LN_TERM_EPS))
            add = valid & ~done
            w = torch.where(add, torch.exp(torch.clamp(q, max=LN_ALPHA_MAX) + Tr), 0.0)
            acc = acc + w[None] * color
            Tr = torch.where(add, Tr + wl, Tr)
            continue
        wlog = L(-alpha)
        T_raw = E(wlog if variant == "nomm" else cum) * Tr
        dead_k = (T_raw * (1.0 - alpha) < TERM_EPS) | done
        add = live & ~dead_k
        w = torch.where(add, alpha * T_raw, 0.0)
        acc = acc + w[None] * color
        kept = torch.where(add, kept + wlog, kept)
        cum = cum + wlog
        dead = torch.where(live, dead_k, dead)
        end = live & _chunk_end(k, n)
        Tr = torch.where(end, Tr * E(kept), Tr)
        done = torch.where(end, dead, done)
        cum, kept = torch.where(end, 0.0, cum), torch.where(end, 0.0, kept)
    tfinal = torch.exp(Tr) if logsp else Tr
    return acc.permute(1, 2, 0).contiguous(), tfinal[:, :, None], visits


def composite_tiles_fwd_variant_plain(variant, tile_quad, tile_color, tile_counts, tile_shape,
                                      tile_origins) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_fwd_variant``: (accum, tfinal)."""
    return composite_tiles_fwd_variant_plain_with_visits(variant, tile_quad, tile_color,
                                                         tile_counts, tile_shape,
                                                         tile_origins)[:2]


def composite_tiles_bwd_variant_plain_with_stats(
    variant, tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal, tile_shape,
    tile_origins,
) -> Tuple[torch.Tensor, torch.Tensor, BackwardStats]:
    """Plain version of ``composite_tiles_bwd_variant``, the replay of the
    variant's forward with each row's gradient summed over the tile's
    pixels, and the replay's work (visits as in the forward's plain version,
    and the contributing ones). pipe, fusedgrad and noT change only how the
    kernel stages rows or sums over pixels: their output is base's; nograd's
    is zero after base's replay."""
    _variant_id(variant, BWD_VARIANTS)
    if variant in ("base", "pipe", "fusedgrad", "noT", "nograd"):
        dquad, dcolor, stats = composite_rm_bwd_plain_with_stats(
            tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal, tile_shape,
            tile_origins)
        if variant == "nograd":
            dquad, dcolor = torch.zeros_like(dquad), torch.zeros_like(dcolor)
        return dquad, dcolor, stats
    T, K, _ = tile_quad.shape
    dev = tile_quad.device
    dquad = torch.zeros(T, K, 8, device=dev)
    dcolor = torch.zeros(T, K, 4, device=dev)
    px, py = _tile_pixels(T, tile_shape, dev, tile_origins)
    lx, ly = _tile_pixels(T, tile_shape, dev)
    basis = (None, lx, ly, lx * lx, lx * ly, ly * ly)
    n = torch.clamp(tile_counts.long(), max=K)
    g = [g_accum[:, :, c] for c in range(4)]
    A_p = (g[0] * accum[:, :, 0] + g[1] * accum[:, :, 1] + g[2] * accum[:, :, 2]
           + g[3] * accum[:, :, 3] + g_tfinal[:, :, 0] * tfinal[:, :, 0])
    E, L = _probe_fns(variant)
    logsp = variant in ("logsp", "noT+logsp")
    chunked = variant in ("noexp", "nomm", "chunk")
    Tr = torch.full_like(px, 0.0 if logsp else 1.0)  # logsp: log T; chunked: T0
    prefix = torch.zeros_like(px)  # chunked: the carry at the chunk start
    done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
    cum, kept, chunk_prefix, last_prefix = (torch.zeros_like(px) for _ in range(4))
    dead = torch.zeros_like(done)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(int(n.max()) if T else 0):
        live = (k < n)[:, None]
        visits += (live & ~done).sum()
        q, log_op, extra = _conic_q(tile_quad[:, k], px, py)
        col = tile_color[:, k]
        cg = g[0] * col[:, 0:1] + g[1] * col[:, 1:2] + g[2] * col[:, 2:3] + g[3] * col[:, 3:4]
        e = E(q)
        valid = (q <= log_op) & (e >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(e, max=ALPHA_MAX), 0.0)
        if chunked:
            wlog = L(-alpha)
            T_raw = E(wlog if variant == "nomm" else cum) * Tr
            dead_k = (T_raw * (1.0 - alpha) < TERM_EPS) | done
            alpha_eff = torch.where(dead_k, 0.0, alpha)
            w = alpha_eff * T_raw
            if variant == "nomm":
                P_incl = prefix + w * cg
            else:
                chunk_prefix = chunk_prefix + w * cg
                P_incl = prefix + chunk_prefix
            last_prefix = torch.where(live, P_incl, last_prefix)
            hit = valid & ~dead_k
            dq = torch.where(hit, (T_raw * cg - (A_p - P_incl) / (1.0 - alpha_eff)) * e, 0.0)
            kept = torch.where(hit, kept + wlog, kept)
            cum = cum + wlog
            dead = torch.where(live, dead_k, dead)
            end = live & _chunk_end(k, n)
            Tr = torch.where(end, Tr * E(kept), Tr)
            prefix = torch.where(end, last_prefix, prefix)
            done = torch.where(end, dead, done)
            cum, kept, chunk_prefix = (torch.where(end, 0.0, x) for x in (cum, kept, chunk_prefix))
        else:
            if logsp:
                T_c, T_next = torch.exp(Tr), Tr + torch.log1p(-alpha)
                done = done | (valid & (T_next < LN_TERM_EPS))
            else:
                T_c, T_next = Tr, Tr * (1.0 - alpha)
                done = done | (valid & (T_next < TERM_EPS))
            hit = valid & ~done
            w = torch.where(hit, alpha * T_c, 0.0)
            prefix = torch.where(hit, prefix + w * cg, prefix)
            dq = torch.where(hit, (T_c * cg - (A_p - prefix) / (1.0 - alpha)) * e, 0.0)
            Tr = torch.where(hit, T_next, Tr)
        hits += hit.sum()
        if variant == "nodeloc":
            dquad[:, k, 0] = dq.sum(1)
            for c in range(1, 6):
                dquad[:, k, c] = (dq * basis[c]).sum(1)
        else:
            dquad[:, k, 0:6] = _conic_row_grad(dq, extra)
        for c in range(4):
            dcolor[:, k, c] = (w * g[c]).sum(1)
    return dquad, dcolor, BackwardStats(int(visits), int(hits))


def composite_tiles_bwd_variant_plain(variant, tile_quad, tile_color, tile_counts, g_accum,
                                      g_tfinal, accum, tfinal, tile_shape,
                                      tile_origins) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``composite_tiles_bwd_variant``: (dquad, dcolor)."""
    if _variant_id(variant, BWD_VARIANTS) == VARIANT_IDS["nograd"]:
        T, K, _ = tile_quad.shape
        return (torch.zeros(T, K, 8, device=tile_quad.device),
                torch.zeros(T, K, 4, device=tile_quad.device))
    return composite_tiles_bwd_variant_plain_with_stats(
        variant, tile_quad, tile_color, tile_counts, g_accum, g_tfinal, accum, tfinal, tile_shape,
        tile_origins)[:2]


def composite_tiles_fwd_variant(variant: str, tile_quad, tile_color, tile_counts, tile_shape,
                                tile_origins) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of ``composite_tiles_fwd`` with origins (global conic
    rows) by kernel 5's pair body under ``variant`` (one of FWD_VARIANTS);
    ``base`` is kernel 5's code unstubbed, launched and counted here like
    every variant. Replaces the Pallas kernel of
    tools/kvariants.py:build_fwd."""
    vid = _variant_id(variant, FWD_VARIANTS)
    if _on_cpu(tile_quad):
        return composite_tiles_fwd_variant_plain(variant, tile_quad, tile_color, tile_counts,
                                                 tile_shape, tile_origins)
    if tile_origins is None:
        raise ValueError("the stage probes take global conic rows and tile_origins")
    return _fwd_rm(composite_tiles_fwd_variant, tile_quad, tile_color, tile_counts, tile_shape,
                   tile_origins, vid)


composite_tiles_fwd_variant.launches = 0


def composite_tiles_bwd_variant(variant: str, tile_quad, tile_color, tile_counts, g_accum,
                                g_tfinal, accum, tfinal, tile_shape,
                                tile_origins) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of ``composite_tiles_bwd`` with origins by kernel 6's
    pair body under ``variant`` (one of BWD_VARIANTS); ``base`` is kernel
    6's code unstubbed, counted here like every variant. Replaces the Pallas
    kernel of tools/kvariants.py:build_bwd."""
    vid = _variant_id(variant, BWD_VARIANTS)
    if _on_cpu(tile_quad):
        return composite_tiles_bwd_variant_plain(variant, tile_quad, tile_color, tile_counts,
                                                 g_accum, g_tfinal, accum, tfinal, tile_shape,
                                                 tile_origins)
    if tile_origins is None:
        raise ValueError("the stage probes take global conic rows and tile_origins")
    return _bwd_rm(composite_tiles_bwd_variant, tile_quad, tile_color, tile_counts, g_accum,
                   g_tfinal, accum, tfinal, tile_shape, tile_origins, vid)


composite_tiles_bwd_variant.launches = 0


# --------------------------------------------------------------------------
# per-tile windows (csrc/windows.cu; replaces tools/win_probe.py:windows_dma)
# --------------------------------------------------------------------------


def tile_windows_plain(starts, rank_pad, K: int, n: int) -> torch.Tensor:
    """Plain version of ``tile_windows``: binning's own gather."""
    from .binning import _windows

    starts = starts.long()
    return _windows(rank_pad, starts, starts[1:] - starts[:-1], n, K)


def _lib_windows() -> ctypes.CDLL:
    lib = cuda_build.load("windows")
    lib.tile_windows.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.launch_floor.argtypes = [_P]
    for fn in (lib.tile_windows, lib.launch_floor):
        fn.restype = _I
    return lib


def tile_windows(starts, rank_pad, K: int, n: int) -> torch.Tensor:
    """(T, K) int32 windows out[t, k] = rank_pad[starts[t] + k] for k below
    the tile's count starts[t + 1] - starts[t], else n. starts (T + 1,) i32
    non-decreasing, rank_pad (L,) i32 with L >= starts[T] (no padding is
    read). The binnings build their windows with ``binning._windows``, as the
    JAX package's do with a gather: only the probe tool and chip_smoke.py
    launch this kernel."""
    if _on_cpu(starts):
        return tile_windows_plain(starts, rank_pad, K, n)
    T = starts.shape[0] - 1
    dev = starts.device
    _check("starts", starts, torch.int32, (T + 1,), dev)
    _check("rank_pad", rank_pad, torch.int32, (rank_pad.shape[0],), dev)
    out = torch.empty(T, K, dtype=torch.int32, device=dev)
    if T == 0 or K == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib_windows().tile_windows(starts.data_ptr(), rank_pad.data_ptr(), out.data_ptr(), T,
                                         K, n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "tile_windows")
    tile_windows.launches += 1
    return out


tile_windows.launches = 0


# --------------------------------------------------------------------------
# pair expansion of the compact and ragged binnings (csrc/binning.cu;
# replaces no TPU kernel: the JAX package forward-fills with lax.cummax)
# --------------------------------------------------------------------------


def expand_pairs_plain(offsets, span, x_lo, y_lo, w, nx: int, num_tiles: int,
                       Pm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``expand_pairs``: each slot's owner by
    ``searchsorted``, then gathers."""
    n = offsets.shape[0]
    j = torch.arange(Pm, dtype=torch.int64, device=offsets.device)
    g = torch.searchsorted(offsets, j, right=True) - 1
    e = j - offsets[g]
    valid = e < span[g]
    wg = torch.clamp(w[g], min=1)
    ty = y_lo[g] + torch.div(e, wg, rounding_mode="floor")
    tile = ty * nx + x_lo[g] + torch.remainder(e, wg)
    return torch.where(valid, tile, num_tiles), torch.where(valid, g, n)


def chunk_slots_plain(bounds, NC: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``chunk_slots``."""
    T = bounds.shape[0] - 1
    c = torch.arange(NC, dtype=torch.int64, device=bounds.device)
    tid = torch.searchsorted(bounds[:T], c, right=True) - 1
    valid = c < bounds[T]
    last = (c == bounds[tid + 1] - 1) & valid
    first = c == bounds[tid]
    flags = first.to(torch.int32) + 2 * last.to(torch.int32) + 4 * valid.to(torch.int32)
    return tid.to(torch.int32), flags


def _lib_binning() -> ctypes.CDLL:
    lib = cuda_build.load("binning")
    lib.expand_pairs.argtypes = [_P] * 7 + [_I, ctypes.c_longlong, _I, _I, _P]
    lib.chunk_slots.argtypes = [_P, _P, _P, _I, _I, _P]
    for fn in (lib.expand_pairs, lib.chunk_slots):
        fn.restype = _I
    return lib


def expand_pairs(offsets, span, x_lo, y_lo, w, nx: int, num_tiles: int,
                 Pm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair budget's slots, each with its owner: the last depth rank g
    whose exclusive offset is <= the slot j. A slot inside g's segment (j <
    offsets[g] + span[g]) gets its tile key, (y_lo + e // w) * nx + x_lo +
    e % w at e = j - offsets[g], and g; any other num_tiles and n. offsets
    (n,) i64 non-decreasing from 0, span, x_lo, y_lo, w (n,) i64, n >= 1 ->
    (tile, rank), (Pm,) i64 each."""
    if _on_cpu(offsets):
        return expand_pairs_plain(offsets, span, x_lo, y_lo, w, nx, num_tiles, Pm)
    n = offsets.shape[0]
    dev = offsets.device
    for name, x in (("offsets", offsets), ("span", span), ("x_lo", x_lo), ("y_lo", y_lo),
                    ("w", w)):
        _check(name, x, torch.int64, (n,), dev)
    if n == 0 or num_tiles >= 1 << 31:
        raise ValueError(f"expand_pairs takes 1 to 2^31 - 1 Gaussians and tiles, got {n}, "
                         f"{num_tiles}")
    tile = torch.empty(Pm, dtype=torch.int64, device=dev)
    rank = torch.empty(Pm, dtype=torch.int64, device=dev)
    if Pm == 0:
        return tile, rank
    with torch.cuda.device(dev):
        rc = _lib_binning().expand_pairs(
            offsets.data_ptr(), span.data_ptr(), x_lo.data_ptr(), y_lo.data_ptr(), w.data_ptr(),
            tile.data_ptr(), rank.data_ptr(), n, Pm, nx, num_tiles,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "expand_pairs")
    expand_pairs.launches += 1
    return tile, rank


expand_pairs.launches = 0


def chunk_slots(bounds, NC: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each of NC chunk slots' tile, the last t with bounds[t] <= the slot c,
    and its flags: bit0 c == bounds[t] (first), bit1 c == bounds[t + 1] - 1
    (last) and bit2 c < bounds[T] (valid), the bits' meaning of the ragged
    layout. bounds (T + 1,) i64 strictly increasing from 0 -> (tid, flags),
    (NC,) i32 each."""
    if _on_cpu(bounds):
        return chunk_slots_plain(bounds, NC)
    T = bounds.shape[0] - 1
    dev = bounds.device
    _check("bounds", bounds, torch.int64, (T + 1,), dev)
    if T < 1:
        raise ValueError("chunk_slots takes at least one tile")
    tid = torch.empty(NC, dtype=torch.int32, device=dev)
    flags = torch.empty(NC, dtype=torch.int32, device=dev)
    if NC == 0:
        return tid, flags
    with torch.cuda.device(dev):
        rc = _lib_binning().chunk_slots(bounds.data_ptr(), tid.data_ptr(), flags.data_ptr(), T,
                                        NC, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "chunk_slots")
    chunk_slots.launches += 1
    return tid, flags


chunk_slots.launches = 0

# every kernel wrapper of this module, for callers that reset or read the
# launch counts
KERNELS = (composite_tiles_fwd_cm, composite_tiles_bwd_cm, composite_tiles_fwd_v2,
           composite_tiles_bwd_v2, composite_tiles_fwd, composite_tiles_bwd,
           composite_pairs_fwd_rg, composite_pairs_bwd_rg, composite_tiles_fwd_variant,
           composite_tiles_bwd_variant, tile_windows, expand_pairs, chunk_slots)
