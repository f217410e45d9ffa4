"""The differentiable part of one train step (counterpart of the
``jax.value_and_grad(loss_fn)`` of exavatar_release_tpu/train/loop.py:
train_step): one ``forward_frame`` in train mode, the total loss, and its
gradient with respect to every trainable and to the scene's screen-space
means. The optimizer update, the densification statistics and cadence, the
capacity governor and checkpoints wait for the next slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

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
) -> Tuple[torch.Tensor, ForwardOutputs, Dict[str, torch.Tensor], torch.Tensor]:
    """Loss of one frame and its gradients. ``bg`` (3,) is the human renders'
    background, which the caller draws from its ``torch.Generator``.

    Returns (total, outputs, grads, g_mean2d): ``grads`` maps every name of
    ``trainables.named_parameters()`` to its gradient (zeros where the loss
    does not reach a parameter); ``g_mean2d`` (C, 2) is d(total)/d(a zero
    offset on the scene's projected means), the densification signal. No
    ``.grad`` field is written."""
    C = trainables.scene.mean.shape[0]
    offset = torch.zeros(C, 2, device=trainables.scene.mean.device, requires_grad=True)
    out = forward_frame(
        trainables, scene_aux, bundle.buffers, bundle.prior, bundle.statics, bundle.id_info,
        bundle.lpips, bundle.face_texture, bundle.face_texture_mask, bundle.init_joint_offset,
        frame, bg, cfg, is_warmup=is_warmup, mode="train", fit_pose_to_test=fit_pose_to_test,
        settings=settings, scene_mean2d_offset=offset,
    )
    total = total_loss(out.losses)
    names, params = zip(*trainables.named_parameters())
    grads = torch.autograd.grad(total, params + (offset,), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params + (offset,))]
    detached = out._replace(
        renders={k: v.detach() for k, v in out.renders.items()},
        losses={k: v.detach() for k, v in out.losses.items()},
    )
    return total.detach(), detached, dict(zip(names, grads[:-1])), grads[-1]
