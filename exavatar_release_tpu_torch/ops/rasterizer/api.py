"""Differentiable 3DGS rasterization (counterpart of
exavatar_release_tpu/ops/rasterizer/api.py:rasterize).

Pipeline:
  project_gaussians                          [preprocess.py]
  -> global depth sort + per-tile binning    [binning.py, integer outputs]
  -> per-tile gather of 12-channel rows
  -> tile compositing: CUDA kernel, or its plain PyTorch version on CPU
     tensors                                 [kernels.py]
  -> image assembly

Gradients: projection, the gather (``index_select``, whose transpose is
``index_add_``) and the image assembly are plain PyTorch under autograd. The
compositing kernels sit in three ``torch.autograd.Function``s whose backward
is the backward kernel (its plain version on CPU tensors), as the JAX
package wraps its Pallas kernels in ``custom_vjp``; the background's
gradient, sum of g_img (1 - mask), is plain PyTorch there too. With
``backend="ref"`` the dense plain forward runs under autograd itself, as
the JAX package's ref backend is ``jax.grad`` over ``jax_ref``: that
gradient is zero through the 0.99 alpha clamp, where the kernels follow
renderCUDA's unclamped rule. Under ``torch.no_grad()`` nothing is saved.

``prepare`` runs everything before the compositing kernel and ``composite``
runs the kernel, so a caller can time the two apart; ``rasterize`` is the
two in a row. With ``in_shard_axis`` set (a rank of a process mesh, inside
a data x tile step) or with a local ``mesh``, ``rasterize`` hands the render
to ``parallel/sharded_raster.py``, which renders row bands through the same
kernels (1 and 2, or 7 and 8 pair-major) at the band's global row offset.

``kernel_v=2`` takes the dense path through the row-major kernels on
pre-packed tile-local coefficients (``pack_tile_quads``), with the background
composite and the image assembly in plain PyTorch, as in the JAX package. Of
its settings, ``prefix_bf16``, ``composite_sub_fwd`` / ``composite_sub_bwd``
and ``interpret`` shaped the TPU kernels' matrix-unit prefixes, row groups
and interpreter and have no counterpart here, so they get no field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ...core.camera import Camera
from . import kernels
from .binning import (
    RaggedBinning,
    TileBinning,
    bin_gaussians_compact,
    bin_gaussians_ragged,
    tile_grid,
)
from .preprocess import ScreenGaussians, pack_tile_quads, project_gaussians

BACKENDS = ("cuda", "ref")


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    tile_h: int = 32
    tile_w: int = 128
    # dense path: per-tile window capacity; overflow is reported in
    # n_truncated (a 166k-Gaussian human at 1080p needs ~16384)
    max_per_tile: int = 1024
    # pair-major path: chunk-slot width, rounded up to a multiple of 128 as
    # in the JAX package so the binning integers match it
    chunk: int = 256
    # "cuda": the hand-written kernels, forward and backward (their plain
    # versions on CPU tensors); "ref": the dense plain forward everywhere,
    # differentiated by autograd, as in JAX
    backend: str = "cuda"
    # dense path's kernel generation. 1: channel-major windows of global
    # conic rows, background composited in the kernel. 2: row-major
    # pre-packed tile-local coefficients; its image differs from 1's at
    # ~1e-5 (another float32 expression for q). Ignored by pair_major and by
    # backend "ref"
    kernel_v: int = 1
    # ragged pair-major compositing: no per-tile capacity, no truncation
    pair_major: bool = False
    # (gaussian, tile) pair budget; <= 0 means pairs_per_gaussian * N.
    # Overflow drops the deepest Gaussians' pairs (n_dropped_pairs)
    max_pairs: int = 0
    pairs_per_gaussian: int = 16
    # pair lanes per Gaussian of the pair-sort binning, which only the
    # sharded dense band uses (rectangles past it are cropped, counted in
    # n_dropped_pairs)
    max_tiles_per_gaussian: int = 64
    # a local mesh (parallel.mesh.make_mesh): rasterize shards the image rows
    # over mesh[shard_axis] in this process (parallel.sharded_raster
    # .rasterize_sharded); with in_shard_axis, the process mesh
    # (parallel.mesh.make_host_mesh) whose axis that is
    mesh: Optional[Any] = None
    shard_axis: str = "tile"
    # this process is one rank of mesh[in_shard_axis] (size in_shard_size):
    # render this rank's row band and all-gather the bands, so every rank
    # gets the full image (rasterize_in_context); the data x tile step
    in_shard_axis: Optional[str] = None
    in_shard_size: int = 0
    # with in_shard_axis: also shard the Gaussians over the axis; each rank
    # projects and bins its N/D slice and an all_to_all routes survivors to
    # their bands (rasterize_gaussian_sharded_in_context)
    gaussian_shard: bool = False
    # per (source rank -> band) bucket capacity of that exchange; <= 0 sizes
    # it as resolve_exchange_cap; overflow is reported (exchange_overflow)
    # and RasterCapacityGovernor doubles it on sustained overflow
    exchange_cap: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.kernel_v not in (1, 2):
            raise ValueError(f"kernel_v must be 1 or 2, got {self.kernel_v!r}")

    def ragged_chunk(self) -> int:
        return max(128, -(-self.chunk // 128) * 128)


class RasterInputs(NamedTuple):
    """Everything the compositing kernel takes, as ``prepare`` leaves it."""

    screen: ScreenGaussians
    binning: Union[TileBinning, RaggedBinning]
    # dense: (T, 12, K) windows; pair-major: (12, Pa); kernel_v=2: (T, K, 8)
    # packed coefficients
    rows: torch.Tensor
    origins: Optional[torch.Tensor]  # dense: (T, 2) tile origins
    tile_shape: Tuple[int, int]
    chunk: int  # pair-major slot width
    color: Optional[torch.Tensor] = None  # kernel_v=2: (T, K, 4) colors


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor of any shape, through
    ``index_select``: its backward is ``index_add_`` (atomic adds), where
    the backward of ``table[idx]`` sorts the indices first, which at the
    millions of pair slots of a frame took most of a backward pass."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


def _row_table(params: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """(N+1, 12) conic+color rows with a sentinel row (log_op = -1e9)."""
    rows = torch.cat([params, color], dim=1)
    sentinel = torch.zeros(1, 12, device=rows.device)
    sentinel[0, 5] = -1e9
    return torch.cat([rows, sentinel], dim=0)


class _CompositeDense(torch.autograd.Function):
    """``composite_tiles_fwd_cm`` with ``composite_tiles_bwd_cm`` as its
    backward: differentiable in ``win`` and ``bg``."""

    @staticmethod
    def forward(ctx, win, counts, origins, bg, tile_shape):
        full = kernels.composite_tiles_fwd_cm(win, counts, origins, bg, tile_shape)
        ctx.save_for_backward(win, counts, origins, bg, full)
        ctx.tile_shape = tile_shape
        return full

    @staticmethod
    def backward(ctx, g_full):
        win, counts, origins, bg, full = ctx.saved_tensors
        # the image assembly's transpose hands over a permuted view
        g_full = g_full.contiguous()
        dwin = kernels.composite_tiles_bwd_cm(win, counts, origins, bg, full, g_full,
                                              ctx.tile_shape)
        return dwin, None, None, _bg_grad(full, g_full), None


class _CompositeRagged(torch.autograd.Function):
    """``composite_pairs_fwd_rg`` with ``composite_pairs_bwd_rg`` as its
    backward: differentiable in ``rows`` and ``bg``."""

    @staticmethod
    def forward(ctx, rows, tid, flags, bg, oy_off, tile_shape, num_tiles, chunk, nx):
        full = kernels.composite_pairs_fwd_rg(rows, tid, flags, bg, oy_off, tile_shape,
                                              num_tiles, chunk, nx)
        ctx.save_for_backward(rows, tid, flags, bg, full)
        ctx.static = (tile_shape, num_tiles, chunk, nx)
        ctx.oy_off = oy_off
        return full

    @staticmethod
    def backward(ctx, g_full):
        rows, tid, flags, bg, full = ctx.saved_tensors
        g_full = g_full.contiguous()
        drows = kernels.composite_pairs_bwd_rg(rows, tid, flags, bg, ctx.oy_off, full, g_full,
                                               *ctx.static)
        return drows, None, None, _bg_grad(full, g_full), None, None, None, None, None


class _CompositeRowMajor(torch.autograd.Function):
    """The row-major kernels behind one boundary (counterpart of the JAX
    package's ``_composite``): ``composite_tiles_fwd_v2`` / ``_bwd_v2`` with
    ``kernel_v == 2``, else ``composite_tiles_fwd`` / ``_bwd``, whose rows
    are global conic rows when ``tile_origins`` is given. Differentiable in
    ``tile_quad`` and ``tile_color``; the backward takes both cotangents."""

    @staticmethod
    def forward(ctx, tile_quad, tile_color, tile_counts, tile_origins, tile_shape, kernel_v):
        if kernel_v == 2:
            accum, tfinal = kernels.composite_tiles_fwd_v2(tile_quad, tile_color, tile_counts,
                                                           tile_shape)
        else:
            accum, tfinal = kernels.composite_tiles_fwd(tile_quad, tile_color, tile_counts,
                                                        tile_shape, tile_origins)
        ctx.save_for_backward(tile_quad, tile_color, tile_counts, tile_origins, accum, tfinal)
        ctx.static = (tile_shape, kernel_v)
        return accum, tfinal

    @staticmethod
    def backward(ctx, g_accum, g_tfinal):
        tile_quad, tile_color, tile_counts, tile_origins, accum, tfinal = ctx.saved_tensors
        tile_shape, kernel_v = ctx.static
        args = (tile_quad, tile_color, tile_counts, g_accum.contiguous(), g_tfinal.contiguous(),
                accum, tfinal, tile_shape)
        if kernel_v == 2:
            dquad, dcolor = kernels.composite_tiles_bwd_v2(*args)
        else:
            dquad, dcolor = kernels.composite_tiles_bwd(*args, tile_origins)
        return dquad, dcolor, None, None, None, None


def _bg_grad(full: torch.Tensor, g_full: torch.Tensor) -> torch.Tensor:
    """d img_c / d bg_c = 1 - mask, per pixel."""
    return torch.sum(g_full[:, 0:3] * (1.0 - full[:, 4:5]), dim=(0, 2))


def prepare(means3d, scales, quats, opacities, rgbs, live, cam: Camera,
            img_shape: Tuple[int, int], settings: RasterizeSettings,
            mean2d_offset: Optional[torch.Tensor] = None) -> RasterInputs:
    """Projection, binning and the depth-sorted gather. ``mean2d_offset``
    (N, 2) is added to the projected means: the gradient with respect to a
    zero offset is the screen-space mean gradient densification reads."""
    H, W = int(img_shape[0]), int(img_shape[1])
    th, tw = settings.tile_h, settings.tile_w
    ny, nx = tile_grid((H, W), th, tw)
    n = means3d.shape[0]
    screen = project_gaussians(means3d, scales, quats, opacities, rgbs, live, cam, (H, W),
                               mean2d_offset)
    max_pairs = settings.max_pairs if settings.max_pairs > 0 else settings.pairs_per_gaussian * n
    rows_pad = _row_table(screen.params, screen.color)

    if settings.pair_major and settings.backend != "ref":
        chunk = settings.ragged_chunk()
        rb = bin_gaussians_ragged(
            screen.mean2d.detach(), screen.radius.detach(), screen.depth.detach(),
            screen.in_frustum, (H, W), th, tw, chunk=chunk, max_pairs=max_pairs,
            extent=screen.extent,
        )
        order_pad = torch.cat([rb.order.long(), rb.order.new_full((1,), n).long()])
        g2 = order_pad[rb.pair_rank.long()]  # (Pa,) original row ids; n = sentinel
        rows2 = _take_rows(rows_pad, g2).T.contiguous()  # (12, Pa) channel-major
        return RasterInputs(screen, rb, rows2, None, (th, tw), chunk)

    binning = bin_gaussians_compact(
        screen.mean2d.detach(), screen.radius.detach(), screen.depth.detach(),
        screen.in_frustum, (H, W), th, tw, settings.max_per_tile,
        max_pairs=max_pairs, extent=screen.extent,
    )
    # compose the depth-sort permutation into the indices instead of
    # reordering the rows
    order_pad = torch.cat([binning.order.long(), binning.order.new_full((1,), n).long()])
    gidx = order_pad[binning.tile_indices.long()]  # (T, K) original row ids
    tile_rows = _take_rows(rows_pad, gidx)  # (T, K, 12)
    t_ids = torch.arange(ny * nx, device=means3d.device)
    origins = torch.stack([(t_ids % nx) * tw, (t_ids // nx) * th], dim=1).float()
    if settings.kernel_v == 2 and settings.backend != "ref":
        tile_quad = pack_tile_quads(tile_rows[..., :8], origins[:, None, :])
        return RasterInputs(screen, binning, tile_quad, origins, (th, tw), 0,
                            tile_rows[..., 8:].contiguous())
    win = tile_rows.transpose(1, 2).contiguous()  # (T, 12, K)
    return RasterInputs(screen, binning, win, origins, (th, tw), 0)


def composite(inputs: RasterInputs, bg: torch.Tensor,
              settings: RasterizeSettings) -> torch.Tensor:
    """The compositing kernel on ``prepare``'s output -> (T, 5, P)."""
    bg = bg.float().contiguous()
    b = inputs.binning
    if inputs.color is not None:
        accum, tfinal = _CompositeRowMajor.apply(inputs.rows, inputs.color, b.tile_counts, None,
                                                 inputs.tile_shape, 2)
        # the row-major kernels leave the background to plain PyTorch
        full = torch.cat([accum[..., 0:3] + tfinal * bg[None, None, :], accum[..., 3:4],
                          1.0 - tfinal], dim=-1)
        return full.permute(0, 2, 1)
    if isinstance(b, RaggedBinning):
        ny, nx = b.num_tiles
        return _CompositeRagged.apply(inputs.rows, b.tid, b.flags, bg, 0.0, inputs.tile_shape,
                                      ny * nx, inputs.chunk, nx)
    if settings.backend == "ref":
        return kernels.composite_tiles_fwd_cm_plain(inputs.rows, b.tile_counts, inputs.origins,
                                                    bg, inputs.tile_shape)
    return _CompositeDense.apply(inputs.rows, b.tile_counts, inputs.origins, bg,
                                 inputs.tile_shape)


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
    """Differentiable render of N world-space Gaussians.

    Returns dict with:
      img   (H, W, 3)  alpha-composited color over ``bg``
      depth (H, W)     expected view-space depth (sum of w_i * z_i)
      mask  (H, W)     accumulated alpha (1 - final transmittance)
      mean2d (N, 2), radius (N,), is_vis (N,), tile_counts (T,)
      n_dropped_pairs  pairs lost to the pair budget
      n_truncated      pairs lost to the dense path's max_per_tile
      n_dropped        the two together on the dense path
    A sharded render (``in_shard_axis`` or ``mesh``) returns the same image
    and statistics, without ``tile_counts``; the Gaussian-sharded ones add
    ``exchange_overflow`` and ``exchange_bytes``.
    """
    if settings.in_shard_axis is not None:
        from ...parallel.sharded_raster import (
            rasterize_gaussian_sharded_in_context,
            rasterize_in_context,
        )

        inner = dataclasses.replace(settings, mesh=None, in_shard_axis=None, in_shard_size=0,
                                    gaussian_shard=False)
        if settings.gaussian_shard:
            return rasterize_gaussian_sharded_in_context(
                means3d, scales, quats, opacities, rgbs, live, cam, img_shape, bg,
                settings.mesh, settings.in_shard_axis, settings.in_shard_size, inner,
                cap=settings.exchange_cap, mean2d_offset=mean2d_offset)
        return rasterize_in_context(
            means3d, scales, quats, opacities, rgbs, live, cam, img_shape, bg, settings.mesh,
            settings.in_shard_axis, settings.in_shard_size, inner, mean2d_offset=mean2d_offset)
    if settings.mesh is not None:
        from ...parallel.sharded_raster import rasterize_sharded

        return rasterize_sharded(
            means3d, scales, quats, opacities, rgbs, live, cam, img_shape, bg, settings.mesh,
            settings.shard_axis, dataclasses.replace(settings, mesh=None),
            mean2d_offset=mean2d_offset)
    H, W = int(img_shape[0]), int(img_shape[1])
    inputs = prepare(means3d, scales, quats, opacities, rgbs, live, cam, (H, W), settings,
                     mean2d_offset)
    full_t = composite(inputs, bg, settings)
    th, tw = inputs.tile_shape
    ny, nx = inputs.binning.num_tiles
    full = (
        full_t.reshape(ny, nx, 5, th, tw).permute(0, 3, 1, 4, 2)
        .reshape(ny * th, nx * tw, 5)[:H, :W]
    )
    b = inputs.binning
    ragged = isinstance(b, RaggedBinning)
    return {
        "img": full[..., 0:3],
        "depth": full[..., 3],
        "mask": full[..., 4],
        "mean2d": inputs.screen.mean2d,
        "radius": inputs.screen.radius,
        "is_vis": inputs.screen.radius > 0,
        "tile_counts": b.tile_counts,
        "n_dropped": b.n_dropped_pairs if ragged else b.n_dropped_pairs + b.n_truncated,
        "n_dropped_pairs": b.n_dropped_pairs,
        "n_truncated": b.n_truncated,
    }
