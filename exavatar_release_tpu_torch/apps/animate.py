"""Animate a trained avatar with new SMPL-X motion (counterpart of the motion
loop of exavatar_release_tpu/apps/animate.py:main and its ``render_assets``).

Only the render path is ported: the CLI (subject loading, checkpoints, the
turntable and view-rotation modes, image and video output) waits for the
apps slice.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..avatar.config import AvatarConfig
from ..avatar.human import HumanBuffers, HumanGaussians, human_forward
from ..avatar.param_dict import PosedSMPLXParams
from ..core.camera import Camera
from ..models.smplx.prior import SMPLXIDInfo, SMPLXPrior
from ..ops.rasterizer.api import RasterizeSettings, rasterize


@torch.no_grad()
def render_motion(
    human: HumanGaussians,
    buffers: HumanBuffers,
    prior: SMPLXPrior,
    id_info: SMPLXIDInfo,
    poses: Sequence[PosedSMPLXParams],
    cams: Sequence[Camera],
    cfg: AvatarConfig,
    settings: RasterizeSettings,
    img_size,
) -> List[Dict[str, torch.Tensor]]:
    """Render one frame per (pose, camera): ``human_forward``, then one
    ``rasterize`` of the refined Gaussians over a white background. Poses
    are in camera coordinates, as the fitted motion files store them.
    Returns each frame's ``rasterize`` output (``img`` is (H, W, 3))."""
    H, W = img_size
    bg = torch.ones(3, device=human.triplane.device)
    frames = []
    for pose, cam in zip(poses, cams, strict=True):
        hout = human_forward(human, buffers, prior, pose, id_info, cam.R, cam.t, cfg)
        a = hout.assets_refined
        frames.append(rasterize(
            a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam, (H, W),
            bg, settings,
        ))
    return frames
