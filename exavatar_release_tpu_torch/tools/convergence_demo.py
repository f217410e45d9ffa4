"""Learning check: the avatar trains to reproduce target renders of a known,
plausible appearance (counterpart of
exavatar_release_tpu/tools/convergence_demo.py).

The target is the same synthetic human with random triplane colors, constant
0.01 Gaussian scales and zero offsets (inside the regularizers' solution
set); the learner trains from the default initialisation through the whole
train step (``train.loop.train_step``: renders, losses, backward, Adam)
under the capacity governor, and the demo reports the PSNR before and after.

    python -m exavatar_release_tpu_torch.tools.convergence_demo [--steps 300]
        [--improvement_db 5] [--backend cuda|ref] [--device cuda|cpu] ...

``backend`` "cuda" runs the hand-written kernels (their plain versions on CPU
tensors), "ref" the plain dense path. The JAX package's bars
(tests/test_convergence.py) are +5 dB in 300 steps at 48x64 and +8 dB in
1000 steps at 512x896 with ``--rings 16 --segs 24 --freeze_pose``.

``AvatarSetup`` is the synthetic setup of the JAX package's test fixture
(tests/avatar_fixture.py): the same numpy draws, from the same seed, in the
same order (scene points, poses, face texture, frames). The human's MLP
heads are drawn as the JAX package's ``init_human(PRNGKey(seed))`` draws them
(``init_heads_as_jax``, ``utils/jax_prng.py``, bit for bit), so that the demo
starts where the JAX demo starts: the PSNR before training, and with it the
gain that the bars hold, depends on that draw by several dB (PERF.md, §6).
LPIPS's random weights come from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..apps.common import synthetic_face_mesh
from ..avatar import scene as sc
from ..avatar.config import AvatarConfig
from ..avatar.human import HumanGaussians, init_human_buffers
from ..avatar.model import AvatarTrainables, FrameData, build_statics, forward_frame
from ..avatar.param_dict import init_param_frames
from ..core.camera import Camera
from ..models.smplx import SMPLXIDInfo, build_prior, synthetic_smplx_assets
from ..ops.image_metrics import psnr
from ..ops.lpips import init_lpips_random
from ..ops.rasterizer.api import RasterizeSettings
from ..train.loop import (
    ModelBundle,
    RasterCapacityGovernor,
    TrainState,
    init_train_state,
    maybe_adjust_gaussians,
    train_step,
)
from ..train.optim import GroupAdam, make_optimizer
from ..utils import jax_prng

# the loss dict's diagnostics, left out of the progress line
_DIAGNOSTICS = ("total", "raster_dropped", "raster_dropped_pairs", "raster_truncated",
                "raster_exchange_overflow")


# HumanGaussians' MLP heads in the order of the JAX package's init_human,
# which splits PRNGKey(seed) into one key per head
JAX_HEAD_ORDER = ("geo_net", "mean_offset_net", "scale_net", "geo_offset_net",
                  "mean_offset_offset_net", "scale_offset_net", "rgb_net", "rgb_offset_net")


@torch.no_grad()
def init_heads_as_jax(human: HumanGaussians, seed: int) -> None:
    """Draw the heads' linear layers as ``init_human(PRNGKey(seed))`` and
    ``init_mlp`` draw them (per head ``split(key, 2 n)``, then weight and bias
    uniform in +-1/sqrt(fan_in)); the JAX (C_in, C_out) weight transposed.
    GroupNorm scales and biases stay at ones and zeros, as in JAX."""
    keys = jax_prng.split(jax_prng.prng_key(seed), len(JAX_HEAD_ORDER))
    for name, key in zip(JAX_HEAD_ORDER, keys):
        linears = getattr(human, name).linears
        lk = jax_prng.split(key, 2 * len(linears))
        for i, lin in enumerate(linears):
            b = np.float32(1.0) / np.sqrt(np.float32(lin.in_features))
            w = jax_prng.uniform(lk[2 * i], (lin.in_features, lin.out_features), -b, b)
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            lin.bias.copy_(torch.from_numpy(jax_prng.uniform(lk[2 * i + 1], (lin.out_features,),
                                                             -b, b)))


class AvatarSetup:
    """The synthetic end-to-end setup on ``device``: a small synthetic body,
    a seeded scene of ``n_scene`` points, ``n_frames`` posed frames with
    random images, random LPIPS, the rasterizer's settings; the human heads
    drawn by ``init_heads_as_jax``."""

    def __init__(self, seed=0, H=48, W=64, n_frames=2, capacity=512, n_scene=200,
                 lpips_net="alex", rings=8, segs=12, backend="cuda", max_per_tile=512,
                 focal=60.0, device="cuda"):
        dev = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        self.cfg = AvatarConfig(triplane_ch=8, triplane_res=16, scene_capacity=capacity)
        self.H, self.W = H, W
        rng = np.random.default_rng(seed)
        self.prior = build_prior(synthetic_smplx_assets(rings=rings, segs=segs, num_shape=6,
                                                        num_expr=4, device=dev))
        a = self.prior.assets
        self.id_info = SMPLXIDInfo.zeros(a.num_shape, a.num_vertices, a.num_joints, device=dev)
        self.human = HumanGaussians(self.cfg, a.num_shape, a.num_joints,
                                    generator=torch.Generator().manual_seed(seed), device=dev)
        init_heads_as_jax(self.human, seed)
        self.buffers = init_human_buffers(self.prior)
        self.statics = build_statics(self.prior, self.buffers, *synthetic_face_mesh(self.prior))

        pts = np.stack([rng.uniform(-3, 3, n_scene), rng.uniform(-1.5, 2, n_scene),
                        rng.uniform(3.0, 5, n_scene)], 1)
        rgbs = rng.uniform(0, 1, (n_scene, 3))
        self.scene_state = sc.init_from_point_cloud(t(pts), t(rgbs), torch.zeros(3, device=dev),
                                                    3.0, capacity)
        frames = [
            {
                "root_pose": np.asarray([np.pi, 0, 0]) + rng.normal(0, 0.05, 3),
                "body_pose": rng.normal(0, 0.1, (21, 3)),
                "jaw_pose": rng.normal(0, 0.05, 3),
                "leye_pose": np.zeros(3),
                "reye_pose": np.zeros(3),
                "lhand_pose": rng.normal(0, 0.1, (15, 3)),
                "rhand_pose": rng.normal(0, 0.1, (15, 3)),
                "expr": rng.normal(0, 0.5, a.num_expr),
                "trans": np.asarray([0.0, 0.1, 2.5]) + rng.normal(0, 0.02, 3),
            }
            for _ in range(n_frames)
        ]
        self.trainables = AvatarTrainables(self.scene_state.params, self.human,
                                           init_param_frames(frames, device=dev))
        self.lpips = init_lpips_random(1, lpips_net, device=dev)
        self.face_texture = t(rng.uniform(0, 1, (3, 16, 16)))
        self.face_texture_mask = torch.ones(1, 16, 16, device=dev)
        self.init_joint_offset = torch.zeros(a.num_joints, 3, device=dev)
        self.settings = RasterizeSettings(backend=backend, max_per_tile=max_per_tile)

        self.frame_data: List[FrameData] = []
        for i in range(n_frames):
            img = rng.uniform(0, 1, (3, H, W))
            mask = np.zeros((1, H, W), np.float32)
            mask[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 1.0
            self.frame_data.append(FrameData(
                img=t(img), mask=t(mask), bbox=t([W * 0.2, H * 0.2, W * 0.6, H * 0.6]),
                cam=Camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                           t([focal, focal]), t([W / 2.0, H / 2.0])),
                frame_row=i))

    def bundle(self) -> ModelBundle:
        return ModelBundle(
            buffers=self.buffers, prior=self.prior, statics=self.statics, id_info=self.id_info,
            lpips=self.lpips, face_texture=self.face_texture,
            face_texture_mask=self.face_texture_mask, init_joint_offset=self.init_joint_offset)


def build_setup(H=48, W=64, rings=8, segs=12, backend="cuda", max_per_tile=512, capacity=256,
                n_scene=120, n_frames=2, device="cuda") -> AvatarSetup:
    """The demo's setup: focal 60 px at 48 rows, scaled with H."""
    return AvatarSetup(H=H, W=W, capacity=capacity, n_scene=n_scene, n_frames=n_frames,
                       rings=rings, segs=segs, backend=backend, max_per_tile=max_per_tile,
                       focal=60.0 * (H / 48.0), device=device)


@torch.no_grad()
def constant_head(mlp, value: float):
    """An MLP head that emits ``value`` everywhere: zero weights, every bias
    ``value`` (in place; returns ``mlp``)."""
    for lin in mlp.linears:
        lin.weight.zero_()
        lin.bias.fill_(value)
    return mlp


class Demo(NamedTuple):
    """A prepared run: the learner's state, the targets, and what the loop
    and the renders need."""

    setup: AvatarSetup
    cfg: AvatarConfig
    bundle: ModelBundle
    target: AvatarTrainables  # the appearance the learner is to reproduce
    frames: List[FrameData]  # the setup's frames with the target renders as images
    eval_settings: RasterizeSettings
    optimizer: GroupAdam
    state: TrainState
    governor: RasterCapacityGovernor
    init_frames: Dict[str, torch.Tensor]  # the learner's per-frame params at the start


@torch.no_grad()
def render(d: Demo, trainables: AvatarTrainables, aux: sc.SceneAux, frame: FrameData):
    """(H, W, 3) test-mode ``scene_human_img`` over a white background, at the
    eval settings' pair budget."""
    s = d.setup
    dev = frame.img.device
    out = forward_frame(trainables, aux, s.buffers, s.prior, s.statics, s.id_info, s.lpips,
                        s.face_texture, s.face_texture_mask, s.init_joint_offset, frame,
                        torch.ones(3, device=dev), d.cfg, is_warmup=False, mode="test",
                        settings=d.eval_settings)
    return out.renders["scene_human_img"]


def eval_psnr(d: Demo, trainables: AvatarTrainables, aux: sc.SceneAux) -> float:
    """Mean PSNR (dB) of the clipped renders against the target images."""
    return float(np.mean([
        float(psnr(torch.clamp(render(d, trainables, aux, fd).permute(2, 0, 1), 0, 1), fd.img))
        for fd in d.frames]))


def prepare(s: AvatarSetup, steps: int, lr_scale: float = 1.0, freeze_pose: bool = False,
            densify: bool = False, pose_perturb: float = 0.0, pair_major: bool = False,
            eval_ppg: int = 128, densify_thr: float = 0.0,
            log: Callable[[str], None] = print) -> Demo:
    """The JAX demo's run setup on ``s``: the learner's scale head at
    log(0.01), the target appearance (triplanes from
    ``np.random.default_rng(7)``, constant heads), the densify cadence and
    the learner's pose noise when asked, the target images rendered at
    ``eval_ppg`` pairs per Gaussian, Adam over a horizon of ``steps``."""
    cfg = s.cfg
    if pair_major:
        s.settings = dataclasses.replace(s.settings, pair_major=True)
    if lr_scale != 1.0:
        cfg = dataclasses.replace(cfg, lr=cfg.lr * lr_scale)
    if densify:
        # the reference cadence compressed onto this run's horizon: densify in
        # [5%, 70%) every max(50, steps/20); one opacity reset at 40%; SH
        # degree up every steps/4
        cfg = dataclasses.replace(
            cfg, densify_start_itr=max(cfg.warmup_itr, steps // 20),
            densify_end_itr=int(steps * 0.7), densify_interval=max(50, steps // 20),
            opacity_reset_interval=int(steps * 0.4),
            increase_sh_degree_interval=max(1, steps // 4))
        if densify_thr > 0.0:
            cfg = dataclasses.replace(cfg, densify_grad_thr=densify_thr)
    if freeze_pose:
        # the targets render the true per-frame params: training them while
        # the appearance is still wrong invites a push-the-body-away minimum
        cfg = dataclasses.replace(cfg, smplx_param_lr=0.0)

    learner = s.trainables
    # start the learner at a plausible log-scale (0.01 m): random heads emit
    # ~1 m Gaussians that span every tile, and the per-tile capacity would
    # truncate them (a capacity pathology, not the learning this checks)
    with torch.no_grad():
        learner.human.scale_net.linears[-1].bias.fill_(math.log(0.01))
    rng = np.random.default_rng(7)
    target = copy.deepcopy(learner)
    h = target.human
    dev = h.triplane.device
    with torch.no_grad():
        h.triplane.copy_(torch.from_numpy(
            rng.normal(0, 0.5, tuple(h.triplane.shape)).astype(np.float32)).to(dev))
        h.triplane_face.copy_(torch.from_numpy(
            rng.normal(0, 0.5, tuple(h.triplane_face.shape)).astype(np.float32)).to(dev))
    constant_head(h.scale_net, math.log(0.01))
    for head in (h.scale_offset_net, h.mean_offset_net, h.mean_offset_offset_net):
        constant_head(head, 0.0)

    learner_aux = s.scene_state.aux
    if densify:
        # under-reconstruction: the learner starts with every second scene
        # Gaussian dead and mild color noise, the targets render them all
        prng2 = np.random.default_rng(5)
        keep = torch.arange(learner.scene.mean.shape[0], device=dev) % 2 == 0
        learner_aux = dataclasses.replace(learner_aux, live=learner_aux.live & keep)
        fdc = learner.scene.feature_dc
        with torch.no_grad():
            fdc.add_(torch.from_numpy(
                prng2.normal(0, 0.1, tuple(fdc.shape)).astype(np.float32)).to(dev))
    if pose_perturb > 0.0:
        # the learner starts from wrong per-frame params (noise in the 6D
        # rotation and translation stores); the targets keep the true ones
        prng = np.random.default_rng(11)
        fr = learner.frames
        with torch.no_grad():
            for p, sd in ((fr.root_pose, pose_perturb), (fr.body_pose, pose_perturb),
                          (fr.trans, pose_perturb * 0.02)):
                p.add_(torch.from_numpy(
                    prng.normal(0, sd, tuple(p.shape)).astype(np.float32)).to(dev))

    # targets and evals at a generous pair budget: a truncated target would
    # make the fit unreachable whatever the training does
    eval_settings = dataclasses.replace(s.settings, pairs_per_gaussian=eval_ppg)
    d = Demo(s, cfg, s.bundle(), target, [], eval_settings, None, None, None, None)
    frames = [fd._replace(img=torch.clamp(
        render(d, target, s.scene_state.aux, fd).permute(2, 0, 1), 0, 1).contiguous())
        for fd in s.frame_data]
    log("targets rendered")

    # the schedule's horizon is the run's length, as in real training
    opt = make_optimizer(learner, cfg, 3.0, tot_itr=steps)
    return d._replace(
        frames=frames, optimizer=opt, state=init_train_state(learner, learner_aux, opt),
        governor=RasterCapacityGovernor(s.settings, log=lambda m: log(f"[governor] {m}")),
        init_frames={k: v.detach().clone() for k, v in learner.frames.named_parameters()})


def step(d: Demo, i: int, generator: Optional[torch.Generator] = None,
         bg: Optional[torch.Tensor] = None):
    """Iteration ``i``: one ``train_step`` on frame ``i % len(frames)`` under
    the governor's settings, the governor's update (one read of the drop
    counters). Returns (demo with the new state, losses)."""
    state, losses = train_step(d.state, d.bundle, d.frames[i % len(d.frames)], d.optimizer,
                               d.cfg, is_warmup=d.cfg.is_warmup(i),
                               settings=d.governor.settings, generator=generator, bg=bg)
    d.governor.update(float(losses["raster_dropped_pairs"]), float(losses["raster_truncated"]))
    return d._replace(state=state), losses


class DemoResult(NamedTuple):
    psnr_before: float
    psnr_after: float
    steps: int  # run to the end, or to a non-finite loss
    ms_per_itr: Optional[float]  # past warm-up; None for runs that end inside it
    dropped_pairs: float  # summed over the steps
    truncated: float
    settings: RasterizeSettings  # as the governor left them


def run(steps: int = 300, H: int = 48, W: int = 64, rings: int = 8, segs: int = 12,
        backend: str = "cuda", max_per_tile: int = 512, capacity: int = 256,
        lr_scale: float = 1.0, dump_dir: str = "", freeze_pose: bool = False,
        eval_every: int = 0, densify: bool = False, pose_perturb: float = 0.0,
        n_scene: int = 120, pair_major: bool = False, eval_ppg: int = 128,
        densify_thr: float = 0.0, device="cuda",
        log: Callable[[str], None] = print) -> DemoResult:
    """The demo's run (``main`` without the bar): setup, targets, ``steps``
    iterations, the PSNR before and after. ``densify`` turns on the
    reference's densify/prune, opacity reset and SH schedule on a cadence
    scaled to the run; ``pose_perturb`` starts the learner from noisy poses
    and reports the pose error before and after."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s = build_setup(H=H, W=W, rings=rings, segs=segs, backend=backend,
                    max_per_tile=max_per_tile, capacity=capacity, n_scene=n_scene, device=dev)
    d = prepare(s, steps, lr_scale, freeze_pose, densify, pose_perturb, pair_major, eval_ppg,
                densify_thr, log)
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = eval_psnr(d, d.state.trainables, d.state.scene_aux)
    log(f"PSNR before: {p0:.2f} dB")
    t_start, done, dropped, truncated = None, 0, 0.0, 0.0
    for i in range(steps):
        d, losses = step(d, i, generator=gen)
        dropped += float(losses["raster_dropped_pairs"])
        truncated += float(losses["raster_truncated"])
        done = i + 1
        if densify:
            state, dstats = maybe_adjust_gaussians(d.state, i, d.cfg, generator=gen)
            d = d._replace(state=state)
            if dstats is not None:
                log(f"itr {i}: densify: +{int(dstats['n_cloned'])} cloned "
                    f"+{int(dstats['n_split'])} split -{int(dstats['n_pruned'])} pruned (live "
                    f"{int(dstats['n_live'])}/{d.state.trainables.scene.mean.shape[0]}, dropped "
                    f"{int(dstats['n_dropped'])})")
        if i == d.cfg.warmup_itr + 1:  # past the warm-up's steps: start the clock
            sync()
            t_start = time.perf_counter()
        if i % 50 == 0:
            top = sorted(((k, float(v)) for k, v in losses.items() if k not in _DIAGNOSTICS),
                         key=lambda kv: -abs(kv[1]))[:4]
            log(f"itr {i}: loss {float(losses['total']):.4f}  ["
                + ", ".join(f"{k}={v:.2f}" for k, v in top)
                + f"] dropped={int(losses['raster_dropped'])}")
        if eval_every and (i + 1) % eval_every == 0:
            log(f"itr {i + 1}: PSNR {eval_psnr(d, d.state.trainables, d.state.scene_aux):.2f} dB")
        if not math.isfinite(float(losses["total"])):
            bad = {k: float(v) for k, v in losses.items() if not math.isfinite(float(v))}
            log(f"itr {i}: NON-FINITE terms: {bad}")
            ok = all(bool(torch.isfinite(p).all()) for p in d.state.trainables.parameters())
            log(f"  trainables finite: {ok}")
            break
    sync()
    ms = None
    if t_start is not None and done > d.cfg.warmup_itr + 2:
        dt = (time.perf_counter() - t_start) / (done - d.cfg.warmup_itr - 2)
        ms = 1e3 * dt
        log(f"speed: {ms:.1f} ms/itr ({1 / dt:.2f} itr/s) at {H}x{W}, backend={backend}, "
            f"device={dev}")
    if dump_dir:
        from ..utils.png import write_png

        os.makedirs(dump_dir, exist_ok=True)
        to_u8 = lambda x: (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        for j, fd in enumerate(d.frames):
            write_png(f"{dump_dir}/pred{j}.png",
                      to_u8(render(d, d.state.trainables, d.state.scene_aux, fd)))
            write_png(f"{dump_dir}/target{j}.png", to_u8(fd.img.permute(1, 2, 0)))
        log(f"dumped renders to {dump_dir}")
    if pose_perturb > 0.0:
        now = {k: v.detach() for k, v in d.state.trainables.frames.named_parameters()}
        truth = {k: v.detach() for k, v in d.target.frames.named_parameters()}

        def pose_dist(a, b):
            rms = lambda k: float(torch.sqrt(torch.mean((a[k] - b[k]) ** 2)))
            return {"root": rms("root_pose"), "body": rms("body_pose"), "trans": rms("trans")}

        log(f"pose error vs truth (rms 6d/m): init {pose_dist(d.init_frames, truth)} -> final "
            f"{pose_dist(now, truth)}")
        log(f"pose movement from init (rms): {pose_dist(now, d.init_frames)}")
    p1 = eval_psnr(d, d.state.trainables, d.state.scene_aux)
    log(f"PSNR after {done} itrs: {p1:.2f} dB (delta {p1 - p0:+.2f})")
    return DemoResult(p0, p1, done, ms, dropped, truncated, d.governor.settings)


def main(steps: int = 300, improvement_db: float = 1.0, H: int = 48, W: int = 64,
         rings: int = 8, segs: int = 12, backend: str = "cuda", max_per_tile: int = 512,
         capacity: int = 256, lr_scale: float = 1.0, dump_dir: str = "",
         freeze_pose: bool = False, eval_every: int = 0, densify: bool = False,
         pose_perturb: float = 0.0, n_scene: int = 120, pair_major: bool = False,
         eval_ppg: int = 128, densify_thr: float = 0.0, device="cuda") -> float:
    """Runs the demo and returns the PSNR gain in dB; raises AssertionError
    unless training improved the PSNR by more than ``improvement_db``."""
    r = run(steps, H, W, rings, segs, backend, max_per_tile, capacity, lr_scale, dump_dir,
            freeze_pose, eval_every, densify, pose_perturb, n_scene, pair_major, eval_ppg,
            densify_thr, device)
    if not r.psnr_after > r.psnr_before + improvement_db:
        raise AssertionError(f"training must improve PSNR by > {improvement_db} dB")
    print("CONVERGENCE OK", flush=True)
    return r.psnr_after - r.psnr_before


def _cli(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--h", type=int, default=48)
    ap.add_argument("--w", type=int, default=64)
    ap.add_argument("--rings", type=int, default=8)
    ap.add_argument("--segs", type=int, default=12)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "ref"],
                    help="cuda: the hand-written kernels (their plain versions on the CPU); "
                         "ref: the plain dense path")
    ap.add_argument("--max_per_tile", type=int, default=512)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--improvement_db", type=float, default=1.0)
    ap.add_argument("--lr_scale", type=float, default=1.0)
    ap.add_argument("--dump_dir", default="")
    ap.add_argument("--freeze_pose", action="store_true")
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--densify", action="store_true",
                    help="full reference recipe: densify/prune + opacity reset + SH schedule "
                         "on the run-scaled cadence")
    ap.add_argument("--pose_perturb", type=float, default=0.0,
                    help="stddev of 6D-rotation noise on the learner's initial per-frame "
                         "SMPL-X params (targets keep the true pose); requires pose lr on")
    ap.add_argument("--n_scene", type=int, default=120)
    ap.add_argument("--pair_major", action="store_true",
                    help="ragged pair-major compositing")
    ap.add_argument("--densify_thr", type=float, default=0.0,
                    help="override densify_grad_thr (0 = reference 2e-4)")
    ap.add_argument("--eval_ppg", type=int, default=128,
                    help="pairs-per-gaussian budget for target/eval renders")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    return main(a.steps, a.improvement_db, H=a.h, W=a.w, rings=a.rings, segs=a.segs,
                backend=a.backend, max_per_tile=a.max_per_tile, capacity=a.capacity,
                lr_scale=a.lr_scale, dump_dir=a.dump_dir, freeze_pose=a.freeze_pose,
                eval_every=a.eval_every, densify=a.densify, pose_perturb=a.pose_perturb,
                n_scene=a.n_scene, pair_major=a.pair_major, eval_ppg=a.eval_ppg,
                densify_thr=a.densify_thr, device=a.device)


if __name__ == "__main__":
    _cli()
