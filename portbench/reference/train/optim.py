"""Optimizer: Adam(eps=1e-15) with named parameter groups and schedules
(counterpart of exavatar_release_tpu/train/optim.py).

* scene mean: Plenoxels exponential schedule scaled by the camera spread;
* scene features / opacity / scale / rotation: constant group rates;
* human nets and per-frame SMPL-X parameters: staged decay (/10 after 75%,
  /100 after 95% of training).

One Adam over the whole trainable module, as the JAX package runs one
``optax.scale_by_adam`` over the whole pytree: the two moments are dicts
keyed by the names of ``trainables.named_parameters()``, so densification can
zero rows of them and capacity growth can pad them, and ONE step count
serves every parameter: moment surgery never resets it, and rows restarted
from zero moments go on with the global bias correction. The learning rate of
update n is ``schedule(n)`` with n counted from 0. ``torch.optim.Adam``
keeps a step per parameter and is not used.

Schedules are evaluated on the host in float32, as the JAX package evaluates
them (they agree within 1e-6 relative). The update writes the parameters
and the moments in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from ..avatar.config import AvatarConfig
from ..avatar.model import AvatarTrainables

_F = np.float32

GROUPS = ("scene_mean", "scene_feature_dc", "scene_feature_rest", "scene_opacity",
          "scene_scale", "scene_rotation", "human", "smplx")


def expon_lr_schedule(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                      lr_delay_mult: float = 1.0,
                      max_steps: int = 1000000) -> Callable[[int], float]:
    """Plenoxels log-linear decay."""

    def sched(step) -> float:
        step = _F(step)
        if lr_delay_steps > 0:
            delay = _F(lr_delay_mult) + _F(1 - lr_delay_mult) * np.sin(
                _F(0.5 * np.pi) * np.clip(step / _F(lr_delay_steps), _F(0), _F(1)))
        else:
            delay = _F(1.0)
        t = np.clip(step / _F(max_steps), _F(0), _F(1))
        log_lerp = np.exp(np.log(_F(lr_init)) * (_F(1) - t) + np.log(_F(lr_final)) * t)
        return float(_F(delay * log_lerp))

    return sched


def staged_decay_schedule(base_lr: float, tot_itr: int) -> Callable[[int], float]:
    """/10 after 75%, /100 after 95% of ``tot_itr``."""

    def sched(step) -> float:
        step = _F(step)
        if step > _F(0.95 * tot_itr):
            return float(_F(base_lr / 100.0))
        if step > _F(0.75 * tot_itr):
            return float(_F(base_lr / 10.0))
        return float(_F(base_lr))

    return sched


def group_label(name: str) -> str:
    """The group of a parameter, from its name in
    ``AvatarTrainables.named_parameters()``: ``scene.<field>`` ->
    ``scene_<field>``, ``human.*`` -> ``human``, ``frames.*`` -> ``smplx``."""
    head, _, rest = name.partition(".")
    if head == "scene":
        return f"scene_{rest}"
    if head == "human":
        return "human"
    return "smplx"


def make_schedules(cfg: AvatarConfig, cam_dist_radius: float, tot_itr: int,
                   fit_pose_to_test: bool = False) -> Dict[str, Callable[[int], float]]:
    if fit_pose_to_test:
        # only the per-frame SMPL-X parameters move, at 1e-3
        sched = {g: (lambda step: 0.0) for g in GROUPS}
        sched["smplx"] = staged_decay_schedule(1e-3, tot_itr)
        return sched
    r = float(cam_dist_radius)
    const = lambda v: (lambda step: float(_F(v)))
    return {
        "scene_mean": expon_lr_schedule(
            cfg.position_lr_init * r, cfg.position_lr_final * r,
            lr_delay_mult=cfg.position_lr_delay_mult, max_steps=cfg.position_lr_max_steps),
        "scene_feature_dc": const(cfg.feature_lr),
        "scene_feature_rest": const(cfg.feature_lr / 20.0),
        "scene_opacity": const(cfg.opacity_lr),
        "scene_scale": const(cfg.scale_lr),
        "scene_rotation": const(cfg.rotation_lr),
        "human": staged_decay_schedule(cfg.lr, tot_itr),
        "smplx": staged_decay_schedule(cfg.smplx_param_lr, tot_itr),
    }


@dataclasses.dataclass
class AdamState:
    """Both moments by parameter name, and the one step count."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


class GroupAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-15 by default) whose learning rate
    comes from a schedule per group label. The object holds no state: ``init``
    makes an ``AdamState`` and ``update`` advances one in place."""

    def __init__(self, labels: Dict[str, str], schedules: Dict[str, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
        missing = set(labels.values()) - set(schedules)
        if missing:
            raise ValueError(f"no schedule for groups {sorted(missing)}")
        self.labels, self.schedules = dict(labels), dict(schedules)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, trainables: AvatarTrainables) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in trainables.named_parameters()}
        return AdamState(mu=zeros(), nu=zeros(), count=0)

    def learning_rates(self, step: int) -> Dict[str, float]:
        return {g: s(step) for g, s in self.schedules.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               trainables: AvatarTrainables) -> AdamState:
        """One step on every parameter, in place: mu, nu, the parameters, and
        the count. The whole tree moves in a few multi-tensor calls."""
        names = [k for k, _ in trainables.named_parameters()]
        lrs = self.learning_rates(state.count)
        adam_step_([p for _, p in trainables.named_parameters()], [grads[k] for k in names],
                   [state.mu[k] for k in names], [state.nu[k] for k in names], state.count + 1,
                   [lrs[self.labels[k]] for k in names], self.b1, self.b2, self.eps)
        state.count += 1
        return state


@torch.no_grad()
def adam_step_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
               nu: List[torch.Tensor], n: int, lrs: List[float], b1: float, b2: float,
               eps: float) -> None:
    """Adam's update number ``n`` (from 1) of ``params``, ``mu`` and ``nu``,
    in place, with a learning rate per parameter: ``optax.scale_by_adam``'s
    arithmetic, in a few multi-tensor calls."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    # update = (mu / c1) / (sqrt(nu / c2) + eps), bias corrections in float32
    c1 = float(_F(1) - _F(b1) ** _F(n))
    c2 = float(_F(1) - _F(b2) ** _F(n))
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mu, c1)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, [-lr for lr in lrs])
    torch._foreach_add_(params, step)


def make_optimizer(trainables: AvatarTrainables, cfg: AvatarConfig, cam_dist_radius: float,
                   tot_itr: int, fit_pose_to_test: bool = False) -> GroupAdam:
    labels = {k: group_label(k) for k, _ in trainables.named_parameters()}
    return GroupAdam(labels, make_schedules(cfg, cam_dist_radius, tot_itr, fit_pose_to_test))


def _scene_names(state: AdamState) -> Iterable[str]:
    return [k for k in state.mu if k.startswith("scene.")]


@torch.no_grad()
def zero_scene_moments(state: AdamState, reset_mask: torch.Tensor) -> AdamState:
    """Zero both moments of the scene rows flagged by ``reset_mask`` (C,), in
    place: new and freed rows restart with zero moments. The step count
    stays."""
    for k in _scene_names(state):
        for m in (state.mu[k], state.nu[k]):
            m[reset_mask] = 0.0
    return state


@torch.no_grad()
def zero_opacity_moments(state: AdamState) -> AdamState:
    """Zero only the scene-opacity moments (opacity reset), in place."""
    state.mu["scene.opacity"].zero_()
    state.nu["scene.opacity"].zero_()
    return state
