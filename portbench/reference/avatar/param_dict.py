"""Per-frame SMPL-X parameters (counterpart of
exavatar_release_tpu/avatar/param_dict.py): one decoded frame in axis-angle,
and the optimizable store of all frames as 6D rotations."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..core.rotations import axis_angle_to_rotation_6d, rotation_6d_to_axis_angle
from ..models.smplx.structs import NUM_BODY_JOINTS, NUM_HAND_JOINTS


@dataclasses.dataclass(frozen=True)
class PosedSMPLXParams:
    """One frame in axis-angle, camera coordinates; identity shape lives
    with the human Gaussian parameters."""

    root_pose: torch.Tensor  # (3,)
    body_pose: torch.Tensor  # (21, 3)
    jaw_pose: torch.Tensor  # (3,)
    leye_pose: torch.Tensor  # (3,)
    reye_pose: torch.Tensor  # (3,)
    lhand_pose: torch.Tensor  # (15, 3)
    rhand_pose: torch.Tensor  # (15, 3)
    expr: torch.Tensor  # (E,)
    trans: torch.Tensor  # (3,)


_POSE_FIELDS = ("root_pose", "body_pose", "jaw_pose", "leye_pose", "reye_pose", "lhand_pose",
                "rhand_pose")


class SMPLXParamFrames(nn.Module):
    """All frames, poses in 6D (the representation that is optimized): one
    stacked parameter per field, a frame lookup is an index."""

    def __init__(self, root_pose, body_pose, jaw_pose, leye_pose, reye_pose, lhand_pose,
                 rhand_pose, expr, trans):
        super().__init__()
        self.root_pose = nn.Parameter(root_pose)  # (F, 6)
        self.body_pose = nn.Parameter(body_pose)  # (F, 21, 6)
        self.jaw_pose = nn.Parameter(jaw_pose)  # (F, 6)
        self.leye_pose = nn.Parameter(leye_pose)  # (F, 6)
        self.reye_pose = nn.Parameter(reye_pose)  # (F, 6)
        self.lhand_pose = nn.Parameter(lhand_pose)  # (F, 15, 6)
        self.rhand_pose = nn.Parameter(rhand_pose)  # (F, 15, 6)
        self.expr = nn.Parameter(expr)  # (F, E)
        self.trans = nn.Parameter(trans)  # (F, 3)

    @property
    def num_frames(self) -> int:
        return self.root_pose.shape[0]

    def lookup(self, frame_row) -> PosedSMPLXParams:
        """Decode one frame back to axis-angle."""
        poses = {f: rotation_6d_to_axis_angle(getattr(self, f)[frame_row]) for f in _POSE_FIELDS}
        return PosedSMPLXParams(expr=self.expr[frame_row], trans=self.trans[frame_row], **poses)


def init_param_frames(per_frame_axis_angle: Sequence[Dict[str, np.ndarray]],
                      device="cuda") -> SMPLXParamFrames:
    """Encode a list of per-frame axis-angle parameter dicts (the fitting
    stage's smplx_params payload) into the 6D store."""
    def stack(name, shape):
        return torch.from_numpy(np.stack(
            [np.asarray(p[name], np.float32).reshape(shape) for p in per_frame_axis_angle]
        )).to(device)

    enc = axis_angle_to_rotation_6d
    return SMPLXParamFrames(
        root_pose=enc(stack("root_pose", (3,))),
        body_pose=enc(stack("body_pose", (NUM_BODY_JOINTS, 3))),
        jaw_pose=enc(stack("jaw_pose", (3,))),
        leye_pose=enc(stack("leye_pose", (3,))),
        reye_pose=enc(stack("reye_pose", (3,))),
        lhand_pose=enc(stack("lhand_pose", (NUM_HAND_JOINTS, 3))),
        rhand_pose=enc(stack("rhand_pose", (NUM_HAND_JOINTS, 3))),
        expr=stack("expr", (-1,)),
        trans=stack("trans", (3,)),
    )
