"""The benchmark's reference rasterizer, in plain PyTorch.

It replaces the program's ``ops/rasterizer/api.py`` (and with it the
compositing kernels and their capacities) in this frozen copy of the
program's plain code. Projection is the copy in ``preprocess.py``. The
binning here is exact and has no capacity: every (Gaussian, tile) pair of
the alpha >= 1/255 rectangle of a visible Gaussian, in depth order within
each tile (the order of a stable sort on depth). The compositor follows
renderCUDA's rules:

* alpha = min(exp(q), 0.99) where q <= log_op and exp(q) >= 1/255, else 0;
* a pixel terminates, sticky, once T (1 - alpha) < 1e-4; the Gaussian that
  would cross the limit is left out;
* out = [rgb + T_final bg, depth, 1 - T_final];
* the backward is the closed form of that blend, with d alpha / d q = exp(q)
  also where alpha was clamped to 0.99.

It is vectorised over tiles: tiles are taken in blocks of similar row
counts, and each block is a (tiles, rows, pixels) tensor of at most
``BLOCK_ELEMENTS`` elements, whose transmittance is a cumulative product
over the rows. The backward recomputes each block.

``COUNTS`` adds up, while ``COUNTS.on``, the work renderCUDA's rules give
the renders: live pairs, tile pixels, visits (rows a pixel evaluates until
it terminates, the trigger included) and, in the backward, the visits that
contribute a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ...core.camera import Camera
from .preprocess import project_gaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TERM_EPS = 1e-4
# elements of one block's (tiles, rows, pixels) tensors: 256 MiB each
BLOCK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Only the tile shape matters here: the reference has no capacity."""

    tile_h: int = 32
    tile_w: int = 128


class WorkCounts:
    """Work of the renders composited while ``on``, by renderCUDA's rules."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self) -> None:
        self.fwd = []  # per forward launch: (pairs, tile pixels, visits)
        self.bwd = []  # per backward launch: (pairs, tile pixels, visits, hits)


COUNTS = WorkCounts()


def tile_grid(img_shape: Tuple[int, int], tile_h: int, tile_w: int) -> Tuple[int, int]:
    H, W = img_shape
    return (-(-H // tile_h), -(-W // tile_w))


def bin_pairs(mean2d, radius, depth, visible, extent, img_shape, tile_h, tile_w):
    """Every pair of a visible Gaussian's rectangle, sorted by tile and, in a
    tile, by depth. Returns (gaussian id per pair, start and count per
    tile)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    ny, nx = tile_grid(img_shape, tile_h, tile_w)
    order = torch.argsort(torch.where(visible, depth, torch.inf), stable=True)
    vis = visible & (radius > 0)
    i64 = torch.int64
    x_lo = torch.clamp(torch.floor((mean2d[:, 0] - extent[:, 0]) / tile_w), 0, nx).to(i64)
    x_hi = torch.clamp(torch.floor((mean2d[:, 0] + extent[:, 0] + tile_w - 1) / tile_w), 0, nx).to(i64)
    y_lo = torch.clamp(torch.floor((mean2d[:, 1] - extent[:, 1]) / tile_h), 0, ny).to(i64)
    y_hi = torch.clamp(torch.floor((mean2d[:, 1] + extent[:, 1] + tile_h - 1) / tile_h), 0, ny).to(i64)
    w = x_hi - x_lo
    span = torch.where(vis, w * (y_hi - y_lo), 0)[order]
    g = torch.repeat_interleave(order, span)
    rank = torch.repeat_interleave(torch.arange(n, device=dev), span)
    first = torch.repeat_interleave(torch.cumsum(span, 0) - span, span)
    e = torch.arange(g.shape[0], device=dev) - first
    tile = (y_lo[g] + torch.div(e, w[g], rounding_mode="floor")) * nx + x_lo[g] + e % w[g]
    perm = torch.argsort(tile * n + rank)
    counts = torch.bincount(tile, minlength=ny * nx)
    starts = torch.cumsum(counts, 0) - counts
    return g[perm], starts, counts


def _blocks(counts: torch.Tensor, P: int):
    """Tile ids in blocks of similar row counts: (tiles (G,), rows K)."""
    c_sorted, ids = torch.sort(counts, descending=True)
    c_host = c_sorted.tolist()
    i, T = 0, len(c_host)
    while i < T:
        K = c_host[i]
        G = T - i if K == 0 else max(1, BLOCK_ELEMENTS // (K * P))
        yield ids[i:i + G], K
        i += G


def _blend(rows, live, px, py):
    """One block's forward quantities: rows (G, K, 12), live (G, K), pixel
    coordinates (G, 1, P)."""
    A, B, C = rows[..., 0:1], rows[..., 1:2], rows[..., 2:3]
    dx = px - rows[..., 3:4]
    dy = py - rows[..., 4:5]
    log_op = rows[..., 5:6]
    q = log_op - 0.5 * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy)
    alpha_un = torch.exp(q)
    valid = (q <= log_op) & (alpha_un >= ALPHA_MIN) & live[..., None]
    alpha = torch.where(valid, torch.clamp(alpha_un, max=ALPHA_MAX), 0.0)
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    done = torch.cumsum((t_incl < TERM_EPS).to(torch.int32), dim=1) > 0
    alpha = torch.where(done, 0.0, alpha)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    w = alpha * t_excl
    return dict(A=A, B=B, C=C, dx=dx, dy=dy, alpha_un=alpha_un, valid=valid, alpha=alpha,
                t_incl=t_incl, done=done, t_excl=t_excl, w=w)


def _block_inputs(pair_rows, starts, counts, tiles, K, nx, tile_shape):
    th, tw = tile_shape
    dev = pair_rows.device
    k = torch.arange(K, device=dev)
    live = k[None, :] < counts[tiles][:, None]
    idx = torch.where(live, starts[tiles][:, None] + k[None, :], 0)
    rows = pair_rows[idx]
    i = torch.arange(th * tw, device=dev)
    px = ((tiles % nx) * tw)[:, None, None].float() + (i % tw).float()[None, None, :]
    py = ((tiles // nx) * th)[:, None, None].float() + (i // tw).float()[None, None, :]
    return rows, live, idx, px, py


def _visits(live, done) -> int:
    before = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]], dim=1)
    return int((live[..., None] & ~before).sum())


class _Composite(torch.autograd.Function):
    """(T, 5, P) composite of the sorted pair rows (Pairs, 12), differentiable
    in the rows and the background."""

    @staticmethod
    def forward(ctx, pair_rows, starts, counts, bg, nx, tile_shape):
        T, P = counts.shape[0], tile_shape[0] * tile_shape[1]
        full = torch.empty(T, 5, P, device=pair_rows.device)
        visits = 0
        for tiles, K in _blocks(counts, P):
            if K == 0:
                full[tiles] = torch.cat([bg, torch.zeros(2, device=bg.device)])[None, :, None]
                continue
            rows, live, _, px, py = _block_inputs(pair_rows, starts, counts, tiles, K, nx,
                                                  tile_shape)
            f = _blend(rows, live, px, py)
            acc = [(f["w"] * rows[..., 8 + c:9 + c]).sum(1) for c in range(4)]
            first_done = f["done"].to(torch.int32).argmax(1, keepdim=True)
            tr = torch.where(f["done"].any(1, keepdim=True),
                             f["t_excl"].gather(1, first_done), f["t_incl"][:, -1:])[:, 0]
            full[tiles] = torch.stack([acc[0] + tr * bg[0], acc[1] + tr * bg[1],
                                       acc[2] + tr * bg[2], acc[3], 1.0 - tr], dim=1)
            if COUNTS.on:
                visits += _visits(live, f["done"])
        if COUNTS.on:
            COUNTS.fwd.append((pair_rows.shape[0], T * P, visits))
        ctx.save_for_backward(pair_rows, starts, counts, bg, full)
        ctx.static = (nx, tile_shape)
        return full

    @staticmethod
    def backward(ctx, g_full):
        pair_rows, starts, counts, bg, full = ctx.saved_tensors
        nx, tile_shape = ctx.static
        g_full = g_full.contiguous()
        T, P = counts.shape[0], tile_shape[0] * tile_shape[1]
        tfinal = 1.0 - full[:, 4]
        g_tf = bg[0] * g_full[:, 0] + bg[1] * g_full[:, 1] + bg[2] * g_full[:, 2] - g_full[:, 4]
        a_p = (g_full[:, 0] * (full[:, 0] - bg[0] * tfinal)
               + g_full[:, 1] * (full[:, 1] - bg[1] * tfinal)
               + g_full[:, 2] * (full[:, 2] - bg[2] * tfinal)
               + g_full[:, 3] * full[:, 3] + g_tf * tfinal)
        d_rows = torch.zeros_like(pair_rows)
        visits = hits = 0
        for tiles, K in _blocks(counts, P):
            if K == 0:
                continue
            rows, live, idx, px, py = _block_inputs(pair_rows, starts, counts, tiles, K, nx,
                                                    tile_shape)
            f = _blend(rows, live, px, py)
            g_acc = [g_full[tiles, c][:, None, :] for c in range(4)]
            cg = sum(g_acc[c] * rows[..., 8 + c:9 + c] for c in range(4))
            pr = torch.cumsum(f["w"] * cg, dim=1)
            hit = f["valid"] & ~f["done"]
            dalpha = f["t_excl"] * cg - (a_p[tiles][:, None, :] - pr) / (1.0 - f["alpha"])
            dq = torch.where(hit, dalpha * f["alpha_un"], 0.0)
            A, B, C, dx, dy = f["A"], f["B"], f["C"], f["dx"], f["dy"]
            grads = [(-0.5 * (dx * dx) * dq).sum(2), (-(dx * dy) * dq).sum(2),
                     (-0.5 * (dy * dy) * dq).sum(2), ((A * dx + B * dy) * dq).sum(2),
                     ((B * dx + C * dy) * dq).sum(2), dq.sum(2)]
            zero = torch.zeros_like(grads[0])
            grads += [zero, zero] + [(f["w"] * g_acc[c]).sum(2) for c in range(4)]
            d_block = torch.stack(grads, dim=2)  # (G, K, 12)
            d_rows[idx[live]] = d_block[live]
            if COUNTS.on:
                visits += _visits(live, f["done"])
                hits += int(hit.sum())
        if COUNTS.on:
            COUNTS.bwd.append((pair_rows.shape[0], T * P, visits, hits))
        d_bg = torch.sum(g_full[:, 0:3] * (1.0 - full[:, 4:5]), dim=(0, 2))
        return d_rows, None, None, d_bg, None, None


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    rgbs: torch.Tensor,
    live: torch.Tensor,
    cam: Camera,
    img_shape: Tuple[int, int],
    bg: torch.Tensor,
    settings: RasterizeSettings = RasterizeSettings(),
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The program's ``rasterize`` contract: img (H, W, 3), depth (H, W), mask
    (H, W), mean2d, radius, is_vis, tile_counts and drop counters (0: the
    reference drops nothing)."""
    H, W = int(img_shape[0]), int(img_shape[1])
    th, tw = settings.tile_h, settings.tile_w
    ny, nx = tile_grid((H, W), th, tw)
    s = project_gaussians(means3d, scales, quats, opacities, rgbs, live, cam, (H, W),
                          mean2d_offset)
    g, starts, counts = bin_pairs(s.mean2d.detach(), s.radius.detach(), s.depth.detach(),
                                  s.in_frustum, s.extent, (H, W), th, tw)
    table = torch.cat([s.params, s.color], dim=1)
    pair_rows = torch.index_select(table, 0, g)
    full_t = _Composite.apply(pair_rows, starts, counts, bg.float(), nx, (th, tw))
    full = (full_t.reshape(ny, nx, 5, th, tw).permute(0, 3, 1, 4, 2)
            .reshape(ny * th, nx * tw, 5)[:H, :W])
    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    return {
        "img": full[..., 0:3], "depth": full[..., 3], "mask": full[..., 4],
        "mean2d": s.mean2d, "radius": s.radius, "is_vis": s.radius > 0,
        "tile_counts": counts.to(torch.int32),
        "n_dropped": zero, "n_dropped_pairs": zero, "n_truncated": zero,
    }
