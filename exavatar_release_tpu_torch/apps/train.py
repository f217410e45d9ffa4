"""Avatar training CLI and its epoch loop (counterpart of
exavatar_release_tpu/apps/train.py).

    python -m exavatar_release_tpu_torch.apps.train --subject_root <dir>
        [--fit_pose_to_test] [--continue_train] [--epochs N] [--out_dir <dir>]
        [--loader auto|native|python] [--device cuda|cpu] ...

``main`` loads the subject, builds the model on ``--device`` and runs
``train_loop``: epochs of ``train_step`` + ``maybe_adjust_gaussians`` under the
capacity governor, frames decoded per step in the epoch's order (the native
prefetcher or cv2, ``--loader``), a ``speed: total(step r read)`` log line per
step and a snapshot per epoch. ``--profile_dir`` traces iterations 20-40
with ``torch.profiler`` into ``<profile_dir>/trace.json`` (a Chrome trace).
``--mesh`` and ``--gaussian_shard`` wait for ``parallel/``; each is refused.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os.path as osp
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Union

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
from ..utils.logging import Timer
from ..utils.profiling import TRACE_FILE, trace

# iterations [start, stop) that ``profile_dir`` traces, as the JAX CLI does
PROFILE_ITRS = (20, 40)

# diagnostics of ``train_step``'s loss dict that are no loss terms
_DIAGNOSTICS = ("raster_dropped", "raster_dropped_pairs", "raster_truncated",
                "raster_exchange_overflow")


class TrainResult(NamedTuple):
    state: TrainState
    settings: RasterizeSettings  # as the governor left them
    history: List[Dict[str, float]]  # per step: itr, epoch, frame, every loss, the diagnostics
    cur_itr: int


class SubjectFrames:
    """A subject's frames as ``train_loop`` takes them: ``epoch(order)``
    decodes each frame when the loop asks for it (the native prefetcher
    keeps a few in flight) and moves it to ``device``."""

    def __init__(self, subject, frame_row_of: Dict[int, int], device, native: bool):
        self.subject, self.frame_row_of, self.device = subject, frame_row_of, device
        self.native = native

    def __len__(self) -> int:
        return len(self.subject.frame_ids)

    def epoch(self, order) -> Iterator[FrameData]:
        from ..data.subject import FramePrefetcher, load_frame_arrays
        from .common import frame_to_device

        arrays = (FramePrefetcher(self.subject, order) if self.native else
                  (load_frame_arrays(self.subject, self.subject.frame_ids[int(k)], use_cv2=True)
                   for k in order))
        try:
            for arrs in arrays:
                arrs["frame_row"] = self.frame_row_of[arrs["frame_idx"]]
                yield frame_to_device(arrs, self.device)
        finally:  # also when the loop stops early: the prefetcher's threads end
            if self.native:
                arrays.close()


class _FramesInMemory:
    def __init__(self, frames: Sequence[FrameData]):
        self.frames = frames

    def __len__(self) -> int:
        return len(self.frames)

    def epoch(self, order) -> Iterator[FrameData]:
        return (self.frames[int(k)] for k in order)


def train_loop(
    state: TrainState,
    bundle: ModelBundle,
    frames: Union[Sequence[FrameData], SubjectFrames],
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
    profile_dir: Optional[str] = None,
) -> TrainResult:
    """Epochs ``start .. cfg.end_epoch`` over ``frames`` (FrameData already on
    the device, or a source with ``len`` and ``epoch(order)`` such as
    ``SubjectFrames``), each epoch in a new
    order drawn from a numpy generator seeded with ``seed``; the backgrounds
    and the split children's noise come from a ``torch.Generator`` of the same
    seed on the state's device. One optimizer step consumes one frame. With
    ``model_dir`` a snapshot is written after every epoch, and
    ``continue_train`` resumes after the newest one found there. ``max_itrs``
    ends the run early (the epoch's snapshot is still written). Reading the
    drop counters for the governor synchronizes with the device once per
    step. Each step's record in ``history`` also holds ``read_s`` (waiting for
    the frame) and ``step_s`` (the step, the adjustment and that transfer),
    and the log line the trainer's ``speed: total(step r read)`` averages of
    the JAX package's Timer (the first ten steps are left out). With
    ``profile_dir`` the iterations ``PROFILE_ITRS`` run under
    ``utils.profiling.trace``, which writes ``profile_dir/trace.json``."""
    log = log or (lambda msg: None)
    dev = state.trainables.scene.mean.device
    source = frames if hasattr(frames, "epoch") else _FramesInMemory(frames)
    itr_per_epoch = len(source)
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
    tot_timer, gpu_timer, read_timer = Timer(), Timer(), Timer()

    cur_itr = start_epoch * itr_per_epoch
    # the trace of PROFILE_ITRS, closed also when the run ends inside them
    with contextlib.ExitStack() as profiling:
        for epoch in range(start_epoch, cfg.end_epoch):
            order = rng.permutation(itr_per_epoch)
            tot_timer.tic()
            read_timer.tic()
            epoch_frames = source.epoch(order)
            for itr, k in enumerate(order):
                frame = next(epoch_frames)
                read_timer.toc()
                if profile_dir is not None and cur_itr == PROFILE_ITRS[0]:
                    profiling.enter_context(trace(profile_dir))
                if profile_dir is not None and cur_itr == PROFILE_ITRS[1]:
                    profiling.close()
                    log(f"profiler trace written to {osp.join(profile_dir, TRACE_FILE)}")
                gpu_timer.tic()
                state, losses = train_step(
                    state, bundle, frame, optimizer, cfg, is_warmup=cfg.is_warmup(cur_itr),
                    fit_pose_to_test=fit_pose_to_test, settings=settings, generator=gen)
                state, dstats = maybe_adjust_gaussians(state, cur_itr, cfg, fit_pose_to_test,
                                                       generator=gen)
                # one transfer for the whole dict: the governor needs the counters
                names = list(losses)
                values = torch.stack([losses[n].float() for n in names]).tolist()
                gpu_timer.toc()
                rec = dict(zip(names, values))
                msg = [f"Epoch {epoch}/{cfg.end_epoch} itr {itr}/{itr_per_epoch}:",
                       "speed: %.2f(%.2fs r%.2f)s/itr" % (tot_timer.average_time,
                                                         gpu_timer.average_time,
                                                         read_timer.average_time)]
                msg += [f"loss_{n}: {v:.4f}" for n, v in rec.items() if n not in _DIAGNOSTICS]
                if rec["raster_dropped"] > 0:
                    msg.append(f"raster_dropped: {int(rec['raster_dropped'])}")
                settings = governor.update(rec["raster_dropped_pairs"], rec["raster_truncated"],
                                           rec["raster_exchange_overflow"])
                if dstats is not None:
                    rec.update({k2: float(v) for k2, v in dstats.items()})
                    msg.append(f"scene_live: {int(dstats['n_live'])}")
                log(" ".join(msg))
                history.append({"itr": cur_itr, "epoch": epoch, "frame": int(k), **rec,
                                "read_s": read_timer.diff, "step_s": gpu_timer.diff})
                tot_timer.toc()
                tot_timer.tic()
                read_timer.tic()
                cur_itr += 1
                if max_itrs is not None and cur_itr >= max_itrs:
                    break
            if model_dir is not None:
                save_checkpoint(model_dir, state, epoch)
                log(f"saved snapshot_{epoch}")
            if max_itrs is not None and cur_itr >= max_itrs:
                break
    return TrainResult(state, settings, history, cur_itr)


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    """The training CLI; returns the loop's result."""
    from .common import (add_common_args, build_prior_for, face_mesh_for, refuse,
                         settings_from_args, subject_bundle)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--fit_pose_to_test", action="store_true")
    ap.add_argument("--continue_train", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=100)
    ap.add_argument("--out_dir", default="output")
    ap.add_argument("--lpips_weights", default=None)
    ap.add_argument(
        "--allow_random_lpips", action="store_true",
        help="train with randomly-initialized LPIPS features. The reference trains against "
             "pretrained VGG-LPIPS at weight 0.2 (reference avatar/common/nets/loss.py:80-97); "
             "results are NOT comparable without real weights, so omitting --lpips_weights is "
             "an error unless this flag is set")
    ap.add_argument("--gender", default="male")
    ap.add_argument("--loader", default="auto", choices=["auto", "native", "python"],
                    help="frame decode pipeline: the native C++ prefetcher or cv2")
    ap.add_argument("--gaussian_shard", action="store_true",
                    help="not ported: waits for parallel/")
    ap.add_argument("--max_itrs", type=int, default=None, help="debug cap")
    ap.add_argument("--profile_dir", default=None,
                    help="trace iterations 20-40 with torch.profiler into <dir>/trace.json")
    ap.add_argument("--mesh", default=None, help="not ported: waits for parallel/")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        refuse("--mesh", "Queue 1 item 5 (parallel/ on torch.distributed)")
    if args.gaussian_shard:
        refuse("--gaussian_shard", "Queue 1 item 5 (parallel/ on torch.distributed)")

    from ..data.subject import load_subject
    from ..native import build_error, native_available
    from ..train.loop import init_train_state
    from ..train.optim import make_optimizer
    from ..utils.logging import make_logger

    dev = torch.device(args.device)
    cfg = AvatarConfig(scene_capacity=args.scene_capacity, triplane_ch=args.triplane_ch,
                       triplane_res=args.triplane_res)
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, end_epoch=args.epochs)
    if args.fit_pose_to_test:
        cfg = dataclasses.replace(cfg, smplx_param_lr=1e-3)
    if args.lpips_weights is None and not args.allow_random_lpips:
        raise SystemExit(
            "training without pretrained LPIPS weights: the perceptual loss (weight 0.2) would "
            "run on random features and the result is not reference-comparable. Pass "
            "--lpips_weights <npz> or opt in explicitly with --allow_random_lpips.")
    use_native = args.loader == "native" or (args.loader == "auto" and native_available())
    if args.loader == "native" and not native_available():
        raise SystemExit(f"--loader native: the native loader could not be built: "
                         f"{build_error()}")

    logger = make_logger(osp.join(args.out_dir, "log"), "train_logs.txt")
    subject = load_subject(args.subject_root,
                           split="test" if args.fit_pose_to_test else "train", repeat=args.repeat)
    prior = build_prior_for(args.human_model_path, args.gender, dev)
    flame_faces, vertex_uv, face_uv = face_mesh_for(args.human_model_path, prior)
    trainables, scene_state, bundle, frame_row_of = subject_bundle(
        subject, prior, cfg, flame_faces, vertex_uv, face_uv, args.lpips_weights,
        use_cv2=not use_native)
    tot_itr = cfg.end_epoch * len(subject.frame_ids)
    opt = make_optimizer(trainables, cfg, float(subject.cam_dist_radius), tot_itr,
                         fit_pose_to_test=args.fit_pose_to_test)
    state = init_train_state(trainables, scene_state.aux, opt)
    governor = RasterCapacityGovernor(settings_from_args(args), log=logger.info)
    logger.info(f"device {dev}; frame loader: "
                + ("the native C++ prefetcher" if use_native else "python (cv2)"))
    return train_loop(state, bundle, SubjectFrames(subject, frame_row_of, dev, use_native), opt,
                      cfg, governor=governor, fit_pose_to_test=args.fit_pose_to_test,
                      model_dir=osp.join(args.out_dir, "model_dump"),
                      continue_train=args.continue_train, max_itrs=args.max_itrs, seed=0,
                      log=logger.info, profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
