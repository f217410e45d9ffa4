"""Combined data x tile parallel avatar training over a two-axis process
mesh (counterpart of exavatar_release_tpu/parallel/dp_tile_train.py).

The mesh is ("data", "tile"): frames are split over "data" as in
``dp_train``, and within each data group every render of a frame is
row-band-sharded over "tile" (``RasterizeSettings.in_shard_axis`` ->
``parallel.sharded_raster.rasterize_in_context``, or with
``gaussian_shard`` the Gaussian-sharded exchange).

Gradient accounting: every tile rank computes the same loss from the
gathered image, times 1/D_tile. The gather's backward reduce-scatters the
pixel cotangents with SUM, so each band's owner gets the whole cotangent of
its band, and one all-reduce over both axes, times 1/B_global, gives the
exact gradient of the global batch's mean loss. The model's replicated
compute (skinning, MLPs, losses) runs on every tile rank; the rasterizer
is what is split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..avatar.config import AvatarConfig
from ..avatar.model import FrameData
from ..ops.rasterizer.api import RasterizeSettings
from ..train.loop import ModelBundle, TrainState
from ..train.optim import GroupAdam
from .dp_train import _dp_step


def dp_tile_train_step(state: TrainState, bundle: ModelBundle,
                       frames: Sequence[Optional[FrameData]], bgs: torch.Tensor,
                       optimizer: GroupAdam, cfg: AvatarConfig, mesh, data_axis: str = "data",
                       tile_axis: str = "tile", is_warmup: bool = False,
                       fit_pose_to_test: bool = False,
                       settings: RasterizeSettings = RasterizeSettings()
                       ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One combined step on a ``ProcessMesh`` ("data", "tile"): the frames
    and backgrounds of the global batch as in ``dp_train_step``, every render
    split into row bands over the tile axis (and, with
    ``settings.gaussian_shard``, its Gaussians too)."""
    d_tile = mesh.shape[tile_axis]
    band = dataclasses.replace(settings, mesh=mesh, in_shard_axis=tile_axis,
                               in_shard_size=d_tile)
    return _dp_step(state, bundle, frames, bgs, optimizer, cfg, mesh, data_axis,
                    (data_axis, tile_axis), 1.0 / d_tile, is_warmup, fit_pose_to_test, band)
