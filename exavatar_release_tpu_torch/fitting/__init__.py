"""SMPL-X / FLAME video fitting, the preprocessing half (counterpart of
exavatar_release_tpu/fitting/).

Per-frame SMPL-X + FLAME parameters, shared identity offsets, 2D-keypoint
reprojection losses and a staged inner optimization: one Adam over all
leaves whose stages are gradient masks (the reference rebuilds a torch Adam
per stage, fitting/common/base.py:47-48; ``reinit_opt_on_stage_change``
restarts the moments at each stage change, which is the same thing). The
frames of a batch go through ``torch.func.vmap``.
"""
from .config import FittingConfig
from .fit import (
    FitState,
    fit_step,
    init_fit_state,
    make_fit_optimizer,
    reinit_opt_on_stage_change,
    stage_flags,
)
from .keypoints import KPT_PART_IDX, SMPLX_KPT_IDX, SMPLX_KPT_NAMES, full_keypoints
from .model import FitFrameData, fitting_forward
from .params import FittingParams, init_fitting_params

__all__ = [
    "FittingConfig",
    "SMPLX_KPT_IDX",
    "SMPLX_KPT_NAMES",
    "KPT_PART_IDX",
    "full_keypoints",
    "FittingParams",
    "init_fitting_params",
    "fitting_forward",
    "FitFrameData",
    "FitState",
    "fit_step",
    "init_fit_state",
    "make_fit_optimizer",
    "reinit_opt_on_stage_change",
    "stage_flags",
]
