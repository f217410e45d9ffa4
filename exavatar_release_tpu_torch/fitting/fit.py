"""Fitting optimizer loop: one Adam step with stage masks (counterpart of
exavatar_release_tpu/fitting/fit.py).

Reference behavior (fitting/main/fit.py:63-131 + common/base.py:41-63):
3 epochs x per-batch inner optimization (500/250 itrs); stage 1 (epoch 0,
itr < 100) unlocks only root poses + translations; then everything; the
last epoch freezes shared identity params; LR starts at 1e-1 (1e-2 later
epochs) and steps down by 10x at fixed itrs. The reference REBUILDS the
torch Adam at each stage change (fresh moments + bias correction); here, as
in the JAX package, the stage is a gradient mask over one Adam of all 17
leaves (one step count; masked leaves get a zero gradient, their moments
still decay), and the fit loop calls ``reinit_opt_on_stage_change`` at stage
boundaries, so a frozen leaf has zero moments and moves exactly 0.

``fit_step`` is a plain function: the forward (``fitting_forward``),
``torch.autograd.grad``, the stage mask, then the Adam update of
``optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)`` in place
(``train.optim.adam_step_``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from ..train.optim import AdamState, adam_step_
from .config import FittingConfig
from .model import FitFrameData, FitStatics, fitting_forward
from .params import FittingParams, stage_mask_tree


@dataclasses.dataclass(frozen=True)
class FitAdam:
    """Adam without a learning rate (it comes with each step): the torch
    default eps=1e-8 of the fitting harness, reference
    fitting/common/base.py:47-48."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: FittingParams) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.named().items()}
        return AdamState(mu=zeros(), nu=zeros(), count=0)


class FitState(NamedTuple):
    params: FittingParams
    opt_state: AdamState


def make_fit_optimizer() -> FitAdam:
    return FitAdam()


def init_fit_state(params: FittingParams, optimizer: FitAdam) -> FitState:
    """The state of ``params``, whose leaves then require gradients."""
    for p in params.named().values():
        p.requires_grad_(True)
    return FitState(params=params, opt_state=optimizer.init(params))


def reinit_opt_on_stage_change(
    state: FitState, optimizer: FitAdam, prev_stage, stage
) -> Tuple[FitState, Tuple]:
    """Fresh Adam moments/step-count when the (root_only, allow_shared)
    membership changes — the functional equivalent of the reference
    rebuilding torch.optim.Adam per stage (fitting/common/base.py:41-63).
    ``stage``/``prev_stage`` are host-side tuples; returns the (possibly
    reset) state and the new prev_stage."""
    if prev_stage is not None and stage == prev_stage:
        return state, stage
    return state._replace(opt_state=optimizer.init(state.params)), stage


def stage_flags(cfg: FittingConfig, epoch: int, itr: int):
    """(lr, root_only, allow_shared, warmup, hand_joint_offset) host-side."""
    return (
        cfg.lr_at(epoch, itr),
        cfg.root_only(epoch, itr),
        not cfg.freeze_shared(epoch),
        cfg.is_warmup(epoch, itr),
        cfg.hand_joint_offset(epoch, itr),
    )


def fit_step(
    state: FitState,
    statics: FitStatics,
    frames: FitFrameData,
    frame_rows: torch.Tensor,
    optimizer: FitAdam,
    lr: float,
    root_only: bool,
    allow_shared: bool,
    warmup: bool,
    hand_joint_offset: bool,
) -> Tuple[FitState, Dict[str, torch.Tensor]]:
    """One step, in place on the state's parameters and moments. Returns the
    state and the loss terms with their sum under "total" (detached)."""
    leaves = state.params.named()
    losses = fitting_forward(state.params, statics, frames, frame_rows, warmup,
                             hand_joint_offset)
    tot = sum(losses.values())
    grads = list(torch.autograd.grad(tot, list(leaves.values()), allow_unused=True,
                                     materialize_grads=True))
    mask = stage_mask_tree(root_only, allow_shared)
    torch._foreach_mul_(grads, [getattr(mask, k) for k in leaves])
    st = state.opt_state
    adam_step_(list(leaves.values()), grads, [st.mu[k] for k in leaves],
               [st.nu[k] for k in leaves], st.count + 1, [lr] * len(leaves), optimizer.b1,
               optimizer.b2, optimizer.eps)
    st.count += 1
    out = {k: v.detach() for k, v in losses.items()}
    out["total"] = tot.detach()
    return state, out
