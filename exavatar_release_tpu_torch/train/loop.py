"""The train step and the host-side cadence around it (counterpart of
exavatar_release_tpu/train/loop.py).

``loss_and_grads`` is the differentiable part: one ``forward_frame`` in train
mode, the total loss, and its gradient with respect to every trainable and to
the scene's screen-space means (the gradient of an explicit zero offset).
``train_step`` goes on to the Adam update, the densification statistics, the
SH degree and the rasterizer's drop counters. Densify/prune and the opacity
reset run on the reference cadence (``maybe_adjust_gaussians``) and zero the
Adam moments of the rows they touch; ``RasterCapacityGovernor`` grows the
rasterizer's capacities when pairs are lost, and ``grow_scene_capacity``
pads the scene when densification runs out of rows.

Where the JAX package returns new pytrees, the port updates in place: a
``TrainState`` that a step returns holds the same ``AvatarTrainables`` module
and the same moment tensors as the one it was given, advanced. Copy a state
(``copy.deepcopy``) to keep it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.rotations import matrix_to_rotation_6d

from ..avatar import scene as sc
from ..avatar.config import AvatarConfig
from ..avatar.human import HumanBuffers
from ..avatar.model import (
    AvatarStatics,
    AvatarTrainables,
    ForwardOutputs,
    FrameData,
    forward_frame,
    total_loss,
)
from ..models.smplx.prior import SMPLXIDInfo, SMPLXPrior
from ..ops.lpips import LPIPSParams
from ..ops.rasterizer.api import RasterizeSettings
from ..utils.profiling import span, spanned
from .optim import AdamState, GroupAdam, zero_opacity_moments, zero_scene_moments


class TrainState(NamedTuple):
    trainables: AvatarTrainables
    opt_state: AdamState
    scene_aux: sc.SceneAux
    itr: int


class ModelBundle(NamedTuple):
    """Everything the step needs besides the trainables and the scene's aux."""

    buffers: HumanBuffers
    prior: SMPLXPrior
    statics: AvatarStatics
    id_info: SMPLXIDInfo
    lpips: LPIPSParams
    face_texture: torch.Tensor
    face_texture_mask: torch.Tensor
    init_joint_offset: torch.Tensor


def loss_and_grads(
    trainables: AvatarTrainables,
    scene_aux: sc.SceneAux,
    bundle: ModelBundle,
    frame: FrameData,
    bg: torch.Tensor,
    cfg: AvatarConfig,
    is_warmup: bool,
    fit_pose_to_test: bool = False,
    settings: RasterizeSettings = RasterizeSettings(),
    loss_scale: float = 1.0,
) -> Tuple[torch.Tensor, ForwardOutputs, Dict[str, torch.Tensor], torch.Tensor]:
    """Loss of one frame and its gradients. ``bg`` (3,) is the human renders'
    background, which the caller draws from its ``torch.Generator``.

    Returns (total, outputs, grads, g_mean2d): ``grads`` maps every name of
    ``trainables.named_parameters()`` to its gradient (zeros where the loss
    does not reach a parameter); ``g_mean2d`` (C, 2) is d(total)/d(a zero
    offset on the scene's projected means), the densification signal. No
    ``.grad`` field is written. ``total`` is the loss times ``loss_scale``,
    which the data x tile step sets to 1/D_tile."""
    C = trainables.scene.mean.shape[0]
    offset = torch.zeros(C, 2, device=trainables.scene.mean.device, requires_grad=True)
    out = forward_frame(
        trainables, scene_aux, bundle.buffers, bundle.prior, bundle.statics, bundle.id_info,
        bundle.lpips, bundle.face_texture, bundle.face_texture_mask, bundle.init_joint_offset,
        frame, bg, cfg, is_warmup=is_warmup, mode="train", fit_pose_to_test=fit_pose_to_test,
        settings=settings, scene_mean2d_offset=offset,
    )
    total = total_loss(out.losses) * loss_scale
    names, params = zip(*trainables.named_parameters())
    with span("train.backward"):
        grads = torch.autograd.grad(total, params + (offset,), allow_unused=True)
    # the outputs leave the graph, which is freed with ``out`` and ``total``
    with span("train.outputs"):
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params + (offset,))]
        detached = out._replace(
            renders={k: v.detach() for k, v in out.renders.items()},
            losses={k: v.detach() for k, v in out.losses.items()},
            scene_radius=out.scene_radius.detach(),
        )
        total = total.detach()
        del out
    return total, detached, dict(zip(names, grads[:-1])), grads[-1]


def init_train_state(trainables: AvatarTrainables, scene_aux: sc.SceneAux,
                     optimizer: GroupAdam) -> TrainState:
    """The state before the first step, on the trainables' device."""
    return TrainState(trainables, optimizer.init(trainables), scene_aux, 0)


@spanned("train.update")
def apply_update(state: TrainState, grads: Dict[str, torch.Tensor], g_mean2d: torch.Tensor,
                 is_vis: torch.Tensor, radius: torch.Tensor, optimizer: GroupAdam,
                 cfg: AvatarConfig, img_shape: Tuple[int, int]) -> TrainState:
    """The update half of a step, shared by ``train_step`` and the data
    parallel steps (``parallel/``): the densification statistics from the
    scene's screen-space mean gradient, visibility and radius (read before
    the update; they use only the scene's aux, which the update does not
    touch), the GroupAdam step and the SH degree."""
    tr = state.trainables
    scene_state = sc.track_stats(sc.SceneState(tr.scene, state.scene_aux), g_mean2d, is_vis,
                                 radius, img_shape=img_shape)
    opt_state = optimizer.update(grads, state.opt_state, tr)
    aux = dataclasses.replace(
        scene_state.aux, active_sh_degree=torch.tensor(float(cfg.sh_degree_at(state.itr)),
                                                       device=tr.scene.mean.device))
    return TrainState(tr, opt_state, aux, state.itr + 1)


def raster_diagnostics(out: ForwardOutputs) -> Dict[str, torch.Tensor]:
    """The (gaussian, tile) pairs a frame lost to the binning capacities and
    to the exchange, as float32 scalars: no loss terms."""
    dev = out.scene_radius.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return {"raster_dropped": f32(out.raster_dropped),
            "raster_dropped_pairs": f32(out.raster_dropped_pairs),
            "raster_truncated": f32(out.raster_truncated),
            "raster_exchange_overflow": f32(out.raster_exchange_overflow)}


@spanned("train.step")
def train_step(
    state: TrainState,
    bundle: ModelBundle,
    frame: FrameData,
    optimizer: GroupAdam,
    cfg: AvatarConfig,
    is_warmup: bool,
    fit_pose_to_test: bool = False,
    settings: RasterizeSettings = RasterizeSettings(),
    generator: Optional[torch.Generator] = None,
    bg: Optional[torch.Tensor] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step on one frame. The human renders' background
    ``bg`` (3,) is uniform in [0, 1), drawn from ``generator`` (on the state's
    device) unless given. Returns (state, loss dict); the dict also carries
    ``total`` and four diagnostics that are no loss terms, the (gaussian,
    tile) pairs this step lost to the binning capacities and the exchange."""
    tr = state.trainables
    if bg is None:
        bg = torch.rand(3, generator=generator, device=tr.scene.mean.device)
    total, out, grads, g_m2d = loss_and_grads(tr, state.scene_aux, bundle, frame, bg, cfg,
                                              is_warmup, fit_pose_to_test, settings)
    state = apply_update(state, grads, g_m2d, out.scene_is_vis, out.scene_radius, optimizer,
                         cfg, (int(frame.img.shape[1]), int(frame.img.shape[2])))
    losses = dict(out.losses)
    losses["total"] = total
    losses.update(raster_diagnostics(out))
    return state, losses


def densify_step(state: TrainState, cfg: AvatarConfig, use_screen_size_prune: bool,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Densify/prune and the surgery on the Adam moments. ``eps`` is the
    split children's noise (see ``scene.densify_and_prune``)."""
    scene_state = sc.SceneState(state.trainables.scene, state.scene_aux)
    res = sc.densify_and_prune(scene_state, cfg, use_screen_size_prune, generator=generator,
                               eps=eps)
    opt_state = zero_scene_moments(state.opt_state, res.reset_mask)
    stats = {
        "n_cloned": res.n_cloned,
        "n_split": res.n_split,
        "n_pruned": res.n_pruned,
        "n_dropped": res.n_dropped,
        "n_live": torch.sum(res.state.aux.live).to(torch.int32),
    }
    return state._replace(opt_state=opt_state, scene_aux=res.state.aux), stats


def opacity_reset_step(state: TrainState) -> TrainState:
    sc.reset_opacity(sc.SceneState(state.trainables.scene, state.scene_aux))
    return state._replace(opt_state=zero_opacity_moments(state.opt_state))


@spanned("train.adjust")
def maybe_adjust_gaussians(
    state: TrainState, cur_itr: int, cfg: AvatarConfig, fit_pose_to_test: bool = False,
    generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
) -> Tuple[TrainState, Optional[Dict[str, torch.Tensor]]]:
    """Host-side cadence: densify every ``densify_interval`` in
    (densify_start_itr, densify_end_itr), with the screen-size prune only
    past ``opacity_reset_interval``; opacity reset at every positive multiple
    of ``opacity_reset_interval``; nothing under ``fit_pose_to_test``."""
    if fit_pose_to_test or cur_itr >= cfg.densify_end_itr:
        return state, None
    stats = None
    if cur_itr > cfg.densify_start_itr and cur_itr % cfg.densify_interval == 0:
        use_screen_prune = cur_itr > cfg.opacity_reset_interval
        state, stats = densify_step(state, cfg, use_screen_prune, generator, eps)
    if cur_itr > 0 and cur_itr % cfg.opacity_reset_interval == 0:
        state = opacity_reset_step(state)
    return state, stats


class RasterCapacityGovernor:
    """Host-side growth of the rasterizer's binning capacities: truncation
    crops footprints AND zeroes the cropped Gaussians' gradients, which
    during warm-up, when the nets emit huge footprints, can make training
    diverge.

    Feed it each step's ``raster_dropped_pairs`` / ``raster_truncated``;
    after ``patience`` consecutive steps with drops it returns grown
    ``RasterizeSettings`` (pair budget x2 on pair drops, per-tile cap x2 on
    truncation, and the ragged pair-major path instead once the cap would
    pass ``pair_major_threshold``, and the Gaussian-sharded exchange's
    ``exchange_cap`` x2 on ``exchange_overflow``). The streaks are separate
    and restart on growth. An automatic ``exchange_cap`` (<= 0) grows from
    ``exchange_cap_floor``, which a caller with ``gaussian_shard`` sets to
    ``parallel.sharded_raster.resolve_exchange_cap(N_max, D)`` so that growth
    never starts below what the automatic cap gave.
    """

    def __init__(self, settings: RasterizeSettings, patience: int = 3,
                 max_pairs_ceiling: int = 1 << 24, max_per_tile_ceiling: int = 1 << 14,
                 log: Optional[Callable[[str], None]] = None, exchange_cap_floor: int = 512,
                 pair_major_threshold: int = 4096):
        self.settings = settings
        self.patience = patience
        self.max_pairs_ceiling = max_pairs_ceiling
        self.max_per_tile_ceiling = max_per_tile_ceiling
        self.exchange_cap_floor = exchange_cap_floor
        self.pair_major_threshold = pair_major_threshold
        self._pair_streak = 0
        self._trunc_streak = 0
        self._xovf_streak = 0
        self._log = log or (lambda msg: None)

    def update(self, dropped_pairs: float, truncated: float,
               exchange_overflow: float = 0.0) -> RasterizeSettings:
        """Record one step's drop counters; returns the (possibly grown)
        settings to use from the next step on."""
        s = self.settings
        self._pair_streak = self._pair_streak + 1 if dropped_pairs > 0 else 0
        self._trunc_streak = self._trunc_streak + 1 if truncated > 0 else 0
        self._xovf_streak = self._xovf_streak + 1 if exchange_overflow > 0 else 0
        if self._xovf_streak >= self.patience:
            self._xovf_streak = 0
            # an automatic cap (<= 0) grows from the caller's resolved floor
            base = s.exchange_cap if s.exchange_cap > 0 else max(512, self.exchange_cap_floor)
            new = min(base * 2, self.max_pairs_ceiling)
            if new != s.exchange_cap:
                self._log(f"raster exchange_cap {s.exchange_cap} -> {new} "
                          f"(sustained exchange_overflow={exchange_overflow:.0f})")
                s = dataclasses.replace(s, exchange_cap=new)
        if self._pair_streak >= self.patience:
            self._pair_streak = 0
            if s.max_pairs > 0:
                new = min(s.max_pairs * 2, self.max_pairs_ceiling)
                if new != s.max_pairs:
                    self._log(f"raster pair budget {s.max_pairs} -> {new} "
                              f"(sustained n_dropped_pairs={dropped_pairs:.0f})")
                    s = dataclasses.replace(s, max_pairs=new)
            else:
                new = min(s.pairs_per_gaussian * 2, max(1, self.max_pairs_ceiling // 1024))
                if new != s.pairs_per_gaussian:
                    self._log(f"raster pairs_per_gaussian {s.pairs_per_gaussian} -> {new} "
                              f"(sustained n_dropped_pairs={dropped_pairs:.0f})")
                    s = dataclasses.replace(s, pairs_per_gaussian=new)
        if self._trunc_streak >= self.patience:
            self._trunc_streak = 0
            new = min(s.max_per_tile * 2, self.max_per_tile_ceiling)
            if not s.pair_major and s.backend != "ref" and new > self.pair_major_threshold:
                # dense windows past this width are mostly empty slots: the
                # ragged path has no per-tile capacity and no truncation
                self._log(f"raster max_per_tile pressure past {self.pair_major_threshold}: "
                          f"switching to pair_major (ragged) compositing "
                          f"(sustained n_truncated={truncated:.0f})")
                s = dataclasses.replace(s, pair_major=True)
            elif new != s.max_per_tile:
                self._log(f"raster max_per_tile {s.max_per_tile} -> {new} "
                          f"(sustained n_truncated={truncated:.0f})")
                s = dataclasses.replace(s, max_per_tile=new)
        self.settings = s
        return s


def grow_scene_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Reallocate the scene when densification keeps dropping requests: the
    six scene parameters are replaced by longer ``nn.Parameter``s (zero rows,
    identity 6D rotation rows), the aux buffers and both Adam moments of
    every scene parameter are padded with zeros (``live`` with False), and the
    step count stays. The human and the per-frame parameters are untouched."""
    scene = state.trainables.scene
    C_old = scene.mean.shape[0]
    if new_capacity < C_old:
        raise ValueError(f"new capacity {new_capacity} below the current {C_old}")
    pad_n = new_capacity - C_old
    if pad_n == 0:
        return state
    dev = scene.mean.device

    def pad_rows(x):
        return torch.cat([x, torch.zeros((pad_n,) + x.shape[1:], dtype=x.dtype, device=dev)])

    ident6 = matrix_to_rotation_6d(torch.eye(3, device=dev)).reshape(1, 6).repeat(pad_n, 1)
    with torch.no_grad():
        for name, p in list(scene.named_parameters()):
            new = torch.cat([p, ident6]) if name == "rotation" else pad_rows(p)
            setattr(scene, name, nn.Parameter(new))
    opt = state.opt_state
    for k in opt.mu:
        if k.startswith("scene."):
            opt.mu[k], opt.nu[k] = pad_rows(opt.mu[k]), pad_rows(opt.nu[k])
    aux = state.scene_aux
    new_aux = dataclasses.replace(
        aux, live=pad_rows(aux.live), radius_max=pad_rows(aux.radius_max),
        xyz_grad_accum=pad_rows(aux.xyz_grad_accum), track_cnt=pad_rows(aux.track_cnt))
    return state._replace(scene_aux=new_aux)
