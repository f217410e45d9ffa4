"""Data-parallel avatar training over a process mesh (counterpart of
exavatar_release_tpu/parallel/dp_train.py).

A batch of frames is split over the mesh's ``data`` axis; each rank runs the
full forward and backward on its frames, the gradients are summed over the
ranks (one all-reduce of one flat buffer) and averaged over the global
batch, and every rank takes the same optimizer step on its replica of the
parameters. Where JAX ``vmap``s the local frames, the port loops over them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..avatar.config import AvatarConfig
from ..avatar.model import FrameData
from ..ops.rasterizer.api import RasterizeSettings
from ..train.loop import (
    ModelBundle,
    TrainState,
    apply_update,
    loss_and_grads,
    raster_diagnostics,
)
from ..train.optim import GroupAdam
from . import collectives as coll


def _broadcast_(t: torch.Tensor, src: int = 0) -> None:
    """``t`` in place from rank ``src``: through a contiguous copy where the
    backend cannot take it as it is (a view, or bool)."""
    if t.is_contiguous() and t.dtype != torch.bool:
        dist.broadcast(t, src=src)
        return
    u = t.to(torch.uint8 if t.dtype == torch.bool else t.dtype).contiguous()
    dist.broadcast(u, src=src)
    t.copy_(u)


def replicate_to_mesh(state: TrainState, mesh=None) -> TrainState:
    """Make every rank's state rank 0's: broadcast every trainable, both Adam
    moments and every tensor of the scene's aux, in place. (JAX places a
    pytree replicated on its mesh; here every process holds its own copy.)"""
    with torch.no_grad():
        for p in state.trainables.parameters():
            _broadcast_(p.data)
        for b in state.trainables.buffers():
            _broadcast_(b)
        for moments in (state.opt_state.mu, state.opt_state.nu):
            for k in sorted(moments):
                _broadcast_(moments[k])
        for f in dataclasses.fields(state.scene_aux):
            _broadcast_(getattr(state.scene_aux, f.name))
    return state


def shard_batch_to_mesh(batch, mesh, axis: str = "data"):
    """This rank's share of a global batch (a sequence of frames, or a
    tensor whose leading axis is the batch): the ranks of ``mesh[axis]``
    take consecutive blocks of B / D."""
    D, r = mesh.shape[axis], mesh.index(axis)
    B = len(batch)
    assert B % D == 0, f"global batch {B} does not split over {axis}={D}"
    b = B // D
    return batch[r * b:(r + 1) * b]


def _dp_step(state: TrainState, bundle: ModelBundle, frames: Sequence[Optional[FrameData]],
             bgs: torch.Tensor, optimizer: GroupAdam, cfg: AvatarConfig, mesh, data_axis: str,
             reduce_axes: Tuple[str, ...], loss_scale: float, is_warmup: bool,
             fit_pose_to_test: bool, settings: RasterizeSettings
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step over this rank's frames of the global batch, the gradients,
    the scaled loss and the densification statistics summed over
    ``reduce_axes``, the loss terms and drop counters over ``data_axis``."""
    tr = state.trainables
    B = len(frames)
    local = shard_batch_to_mesh(list(zip(frames, bgs)), mesh, data_axis)
    grads_sum, terms, g_m2d, vis, radius = None, None, None, None, None
    total = torch.zeros((), device=tr.scene.mean.device)
    for frame, bg in local:
        t, out, grads, g = loss_and_grads(tr, state.scene_aux, bundle, frame, bg, cfg, is_warmup,
                                          fit_pose_to_test, settings, loss_scale=loss_scale)
        stats = torch.stack(list(out.losses.values()) + list(raster_diagnostics(out).values()))
        total = total + t
        if grads_sum is None:
            names = list(out.losses) + list(raster_diagnostics(out))
            grads_sum, terms, g_m2d = grads, stats, g
            vis, radius = out.scene_is_vis.float(), out.scene_radius
        else:
            grads_sum = {k: grads_sum[k] + v for k, v in grads.items()}
            terms, g_m2d = terms + stats, g_m2d + g
            vis, radius = vis + out.scene_is_vis.float(), torch.maximum(radius, out.scene_radius)
    # one all-reduce over both axes: gradients, the scaled loss, the scene's
    # mean2d gradient and its visibility count (float32 counts are exact)
    keys = list(grads_sum)
    flat = torch.cat([grads_sum[k].reshape(-1) for k in keys] + [total.reshape(1), g_m2d.reshape(-1),
                                                                 vis])
    flat = coll.psum(flat, mesh.group(reduce_axes))
    scale = 1.0 / B
    grads, i = {}, 0
    for k in keys:
        n = grads_sum[k].numel()
        grads[k] = flat[i:i + n].reshape(grads_sum[k].shape) * scale
        i += n
    total = flat[i] * scale
    g_m2d = flat[i + 1:i + 1 + g_m2d.numel()].reshape(g_m2d.shape)
    vis_any = flat[i + 1 + g_m2d.numel():] > 0
    radius = coll.pmax(radius, mesh.group(reduce_axes))
    # loss terms and drop counters: identical on a data group's tile ranks
    terms = coll.psum(terms, mesh.group(data_axis))
    n_terms = len(names) - 4
    losses = {k: terms[j] * scale for j, k in enumerate(names[:n_terms])}
    losses["total"] = total
    losses.update({k: terms[n_terms + j] for j, k in enumerate(names[n_terms:])})
    img = local[0][0].img
    state = apply_update(state, grads, g_m2d, vis_any, radius, optimizer, cfg,
                         (int(img.shape[1]), int(img.shape[2])))
    return state, losses


def dp_train_step(state: TrainState, bundle: ModelBundle, frames: Sequence[Optional[FrameData]],
                  bgs: torch.Tensor, optimizer: GroupAdam, cfg: AvatarConfig, mesh,
                  axis: str = "data", is_warmup: bool = False, fit_pose_to_test: bool = False,
                  settings: RasterizeSettings = RasterizeSettings()
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One data-parallel step over a global batch of B = D·b frames on a
    ``ProcessMesh``: rank r takes frames [r·b, (r+1)·b) (the others may be
    None) and the rows of ``bgs`` (B, 3), the human renders' backgrounds,
    that go with them, so that every layout of one batch draws the same
    colours. Every frame goes through ``loss_and_grads``; the gradients are
    summed over the axis and scaled by 1/B, the scene's mean2d gradients
    summed, its visibility OR-ed and its radius maxed (the densification
    statistics of each frame, as the reference accumulates them per item),
    and every rank takes the same update. Returns (state, losses): the mean
    total and loss terms over the batch and the drop counters summed."""
    return _dp_step(state, bundle, frames, bgs, optimizer, cfg, mesh, axis, (axis,), 1.0,
                    is_warmup, fit_pose_to_test, settings)
