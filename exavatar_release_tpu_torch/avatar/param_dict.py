"""Per-frame SMPL-X pose (counterpart of
exavatar_release_tpu/avatar/param_dict.py:PosedSMPLXParams). The 6D
per-frame store used by training waits for the training slice."""
from __future__ import annotations

import dataclasses

import torch


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
