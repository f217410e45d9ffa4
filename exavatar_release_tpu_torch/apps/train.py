"""Avatar training CLI and its epoch loop (counterpart of
exavatar_release_tpu/apps/train.py).

    python -m exavatar_release_tpu_torch.apps.train --subject_root <dir>
        [--fit_pose_to_test] [--continue_train] [--epochs N] [--out_dir <dir>]
        [--loader auto|native|python] [--device cuda|cpu] ...
    torchrun --nproc_per_node=N -m exavatar_release_tpu_torch.apps.train
        --mesh data=a,tile=b [--gaussian_shard] ...   (N = a*b)

``main`` loads the subject, builds the model on ``--device`` and runs
``train_loop``: epochs of ``train_step`` + ``maybe_adjust_gaussians`` under the
capacity governor, frames decoded per step in the epoch's order (the native
prefetcher or cv2, ``--loader``), a ``speed: total(step r read)`` log line per
step and a snapshot per epoch. ``--profile_dir`` traces iterations 20-40
with ``torch.profiler`` into ``<profile_dir>/trace.json`` (a Chrome trace of
the kernels and of the program's spans, ``utils.profiling.span``).
``--mesh data=a,tile=b`` trains on a process mesh under ``torchrun`` (a*b
processes, one card each): each step takes ``a`` frames, one per data
group, through ``parallel.dp_tile_train_step``, every render split into
``b`` row bands (with ``--gaussian_shard`` its Gaussians too); rank 0 alone
writes the log and the snapshots.
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
from ..parallel import dp_tile_train_step
from ..train.optim import GroupAdam
from ..utils.logging import Timer
from ..utils.profiling import TRACE_FILE, span, trace

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
    mesh=None,
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
    ``utils.profiling.trace``, which writes ``profile_dir/trace.json``.

    With ``mesh`` (a ``ProcessMesh`` ("data", "tile"), this process one
    rank of it) a step consumes one frame per data group: the epoch's order
    is cut into batches of ``mesh.shape["data"]`` frames (the tail shorter
    than that is dropped), this rank decodes only its data group's frames,
    and ``parallel.dp_tile_train_step`` takes the batch with backgrounds
    drawn for all of it, the same on every rank. Only rank 0 writes
    snapshots and traces."""
    log = log or (lambda msg: None)
    dev = state.trainables.scene.mean.device
    source = frames if hasattr(frames, "epoch") else _FramesInMemory(frames)
    d_data = 1 if mesh is None else mesh.shape["data"]
    r_data = 0 if mesh is None else mesh.index("data")
    writer = mesh is None or torch.distributed.get_rank() == 0
    itr_per_epoch = len(source) // d_data
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
            order = rng.permutation(len(source))[:itr_per_epoch * d_data]
            tot_timer.tic()
            read_timer.tic()
            # this rank's frame of every batch of d_data consecutive ones
            epoch_frames = source.epoch(order[r_data::d_data])
            for itr, k in enumerate(order[r_data::d_data]):
                frame = next(epoch_frames)
                read_timer.toc()
                if writer and profile_dir is not None and cur_itr == PROFILE_ITRS[0]:
                    profiling.enter_context(trace(profile_dir))
                if writer and profile_dir is not None and cur_itr == PROFILE_ITRS[1]:
                    profiling.close()
                    log(f"profiler trace written to {osp.join(profile_dir, TRACE_FILE)}")
                gpu_timer.tic()
                if mesh is None:
                    state, losses = train_step(
                        state, bundle, frame, optimizer, cfg, is_warmup=cfg.is_warmup(cur_itr),
                        fit_pose_to_test=fit_pose_to_test, settings=settings, generator=gen)
                else:
                    batch = [None] * d_data
                    batch[r_data] = frame
                    bgs = torch.rand(d_data, 3, generator=gen, device=dev)
                    state, losses = dp_tile_train_step(
                        state, bundle, batch, bgs, optimizer, cfg, mesh,
                        is_warmup=cfg.is_warmup(cur_itr), fit_pose_to_test=fit_pose_to_test,
                        settings=settings)
                state, dstats = maybe_adjust_gaussians(state, cur_itr, cfg, fit_pose_to_test,
                                                       generator=gen)
                # one transfer for the whole dict: the governor needs the counters
                names = list(losses)
                with span("sync.drop_counters"):
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
            if model_dir is not None and writer:
                save_checkpoint(model_dir, state, epoch)
                log(f"saved snapshot_{epoch}")
            if max_itrs is not None and cur_itr >= max_itrs:
                break
    return TrainResult(state, settings, history, cur_itr)


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    """The training CLI; returns the loop's result."""
    from ..parallel import replicate_to_mesh, resolve_exchange_cap
    from .common import (add_common_args, build_prior_for, face_mesh_for, settings_from_args,
                         subject_bundle)

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
                    help="with --mesh tile>1: shard the Gaussians over the tile axis too "
                         "(all_to_all band exchange; per-rank projection and binning N/D)")
    ap.add_argument("--max_itrs", type=int, default=None, help="debug cap")
    ap.add_argument("--profile_dir", default=None,
                    help="trace iterations 20-40 with torch.profiler into <dir>/trace.json: "
                         "the kernels and the program's spans (train.step, model.forward, "
                         "human.forward, raster.prepare, train.backward, ...)")
    ap.add_argument("--mesh", default=None,
                    help="process mesh 'data=a,tile=b' under torchrun (a*b processes): data "
                         "parallel over frames x row-band-sharded rendering "
                         "(parallel.dp_tile_train_step); each step takes a frames")
    args = ap.parse_args(argv)
    mesh = process_mesh(args.mesh, args.device) if args.mesh is not None else None
    if args.gaussian_shard and mesh is None:
        raise SystemExit("--gaussian_shard shards the renders over the tile axis of --mesh: "
                         "give --mesh data=a,tile=b")

    from ..data.subject import load_subject
    from ..native import build_error, native_available
    from ..train.loop import init_train_state
    from ..train.optim import make_optimizer
    from ..utils.logging import make_logger

    dev = torch.device(args.device) if mesh is None else mesh.device
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

    rank0 = mesh is None or torch.distributed.get_rank() == 0
    logger = (make_logger(osp.join(args.out_dir, "log"), "train_logs.txt") if rank0
              else _Silent())
    subject = load_subject(args.subject_root,
                           split="test" if args.fit_pose_to_test else "train", repeat=args.repeat)
    prior = build_prior_for(args.human_model_path, args.gender, dev)
    flame_faces, vertex_uv, face_uv = face_mesh_for(args.human_model_path, prior)
    trainables, scene_state, bundle, frame_row_of = subject_bundle(
        subject, prior, cfg, flame_faces, vertex_uv, face_uv, args.lpips_weights,
        use_cv2=not use_native)
    d_data = 1 if mesh is None else mesh.shape["data"]
    tot_itr = cfg.end_epoch * (len(subject.frame_ids) // d_data)
    opt = make_optimizer(trainables, cfg, float(subject.cam_dist_radius), tot_itr,
                         fit_pose_to_test=args.fit_pose_to_test)
    state = init_train_state(trainables, scene_state.aux, opt)
    settings = dataclasses.replace(settings_from_args(args), gaussian_shard=args.gaussian_shard)
    xcap_floor = 512
    if mesh is not None:
        replicate_to_mesh(state, mesh)
        d_tile = mesh.shape["tile"]
        logger.info(f"mesh: data={d_data} x tile={d_tile} over {d_data * d_tile} processes; "
                    f"{d_data} frames per step")
        if args.gaussian_shard and d_tile > 1:
            # the largest render is scene + human: growth of the exchange's
            # capacity starts from its automatic value
            n_max = int(state.trainables.scene.mean.shape[0]) + int(prior.vertex_num_upsampled)
            xcap_floor = resolve_exchange_cap(n_max, d_tile)
    governor = RasterCapacityGovernor(settings, log=logger.info, exchange_cap_floor=xcap_floor)
    logger.info(f"device {dev}; frame loader: "
                + ("the native C++ prefetcher" if use_native else "python (cv2)"))
    return train_loop(state, bundle, SubjectFrames(subject, frame_row_of, dev, use_native), opt,
                      cfg, governor=governor, fit_pose_to_test=args.fit_pose_to_test,
                      model_dir=osp.join(args.out_dir, "model_dump"),
                      continue_train=args.continue_train, max_itrs=args.max_itrs, seed=0,
                      log=logger.info, profile_dir=args.profile_dir, mesh=mesh)


class _Silent:
    """The logger of ranks other than 0."""

    def info(self, msg: str) -> None:
        pass


def process_mesh(spec: str, device: str):
    """The ``ProcessMesh`` of ``--mesh data=a,tile=b``: this process joins the
    ``torch.distributed`` world that ``torchrun`` (or another launcher that
    ``parallel.init_distributed`` reads) set up, which must hold a*b
    processes."""
    import torch.distributed as dist

    from ..parallel import init_distributed, make_host_mesh

    sizes = dict(kv.split("=") for kv in spec.split(","))
    if set(sizes) - {"data", "tile"}:
        raise SystemExit(f"--mesh {spec}: the axes are data and tile")
    d_data, d_tile = int(sizes.get("data", 1)), int(sizes.get("tile", 1))
    init_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != d_data * d_tile:
        raise SystemExit(
            f"--mesh {spec} needs a torch.distributed world of {d_data * d_tile} processes, one "
            f"per card (this process has {world or 'none'}): torchrun "
            f"--nproc_per_node={d_data * d_tile} -m exavatar_release_tpu_torch.apps.train "
            f"--mesh {spec} ...")
    return make_host_mesh(d_tile=d_tile)


if __name__ == "__main__":
    main()
