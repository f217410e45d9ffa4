"""Train an avatar: the epoch loop (counterpart of the loop of
exavatar_release_tpu/apps/train.py:main).

``train_loop`` takes the frames, the model and the optimizer from its caller
and runs epochs of ``train_step`` + ``maybe_adjust_gaussians`` with the
capacity governor, a snapshot per epoch and resumption from the newest one.
Only the loop is ported: ``main()`` with its subject loading, the native
frame loader and ``--mesh`` waits for the apps slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..avatar.config import AvatarConfig
from ..avatar.model import FrameData
from ..ops.rasterizer.api import RasterizeSettings
from ..train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..train.loop import (
    ModelBundle,
    RasterCapacityGovernor,
    TrainState,
    maybe_adjust_gaussians,
    train_step,
)
from ..train.optim import GroupAdam

# diagnostics of ``train_step``'s loss dict that are no loss terms
_DIAGNOSTICS = ("raster_dropped", "raster_dropped_pairs", "raster_truncated",
                "raster_exchange_overflow")


class TrainResult(NamedTuple):
    state: TrainState
    settings: RasterizeSettings  # as the governor left them
    history: List[Dict[str, float]]  # per step: itr, epoch, frame, every loss, the diagnostics
    cur_itr: int


def train_loop(
    state: TrainState,
    bundle: ModelBundle,
    frames: Sequence[FrameData],
    optimizer: GroupAdam,
    cfg: AvatarConfig,
    settings: RasterizeSettings = RasterizeSettings(),
    governor: Optional[RasterCapacityGovernor] = None,
    fit_pose_to_test: bool = False,
    model_dir: Optional[str] = None,
    continue_train: bool = False,
    max_itrs: Optional[int] = None,
    seed: int = 0,
    log: Optional[Callable[[str], None]] = None,
) -> TrainResult:
    """Epochs ``start .. cfg.end_epoch`` over ``frames``, each epoch in a new
    order drawn from a numpy generator seeded with ``seed``; the backgrounds
    and the split children's noise come from a ``torch.Generator`` of the same
    seed on the state's device. One optimizer step consumes one frame. With
    ``model_dir`` a snapshot is written after every epoch, and
    ``continue_train`` resumes after the newest one found there. ``max_itrs``
    ends the run early (the epoch's snapshot is still written). Reading the
    drop counters for the governor synchronizes with the device once per
    step."""
    log = log or (lambda msg: None)
    dev = state.trainables.scene.mean.device
    itr_per_epoch = len(frames)
    start_epoch = 0
    if continue_train and model_dir is not None:
        ck = latest_checkpoint(model_dir)
        if ck:
            state, start_epoch = load_checkpoint(ck, cfg, dev)
            start_epoch += 1
            log(f"resumed from {ck}")
    governor = governor or RasterCapacityGovernor(settings, log=log)
    settings = governor.settings
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history: List[Dict[str, float]] = []

    cur_itr = start_epoch * itr_per_epoch
    for epoch in range(start_epoch, cfg.end_epoch):
        order = rng.permutation(len(frames))
        for itr, k in enumerate(order):
            state, losses = train_step(
                state, bundle, frames[int(k)], optimizer, cfg, is_warmup=cfg.is_warmup(cur_itr),
                fit_pose_to_test=fit_pose_to_test, settings=settings, generator=gen)
            state, dstats = maybe_adjust_gaussians(state, cur_itr, cfg, fit_pose_to_test,
                                                   generator=gen)
            # one transfer for the whole dict: the governor needs the counters
            names = list(losses)
            values = torch.stack([losses[n].float() for n in names]).tolist()
            rec = dict(zip(names, values))
            msg = [f"Epoch {epoch}/{cfg.end_epoch} itr {itr}/{itr_per_epoch}:"]
            msg += [f"loss_{n}: {v:.4f}" for n, v in rec.items() if n not in _DIAGNOSTICS]
            if rec["raster_dropped"] > 0:
                msg.append(f"raster_dropped: {int(rec['raster_dropped'])}")
            settings = governor.update(rec["raster_dropped_pairs"], rec["raster_truncated"],
                                       rec["raster_exchange_overflow"])
            if dstats is not None:
                rec.update({k2: float(v) for k2, v in dstats.items()})
                msg.append(f"scene_live: {int(dstats['n_live'])}")
            log(" ".join(msg))
            history.append({"itr": cur_itr, "epoch": epoch, "frame": int(k), **rec})
            cur_itr += 1
            if max_itrs is not None and cur_itr >= max_itrs:
                break
        if model_dir is not None:
            save_checkpoint(model_dir, state, epoch)
            log(f"saved snapshot_{epoch}")
        if max_itrs is not None and cur_itr >= max_itrs:
            break
    return TrainResult(state, settings, history, cur_itr)
