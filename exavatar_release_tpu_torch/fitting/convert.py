"""Carry fitting state from the JAX package into the port. The functions take
numpy arrays only (the caller does the ``np.asarray`` on the JAX side) and
import nothing of the JAX package.

``fitting_params_from_jax`` takes the JAX ``FittingParams`` as {leaf name:
array}; ``fit_statics_from_numpy`` takes the JAX ``FitStatics``' tables as
{field name: array} (its two ear vertex ids as ints) with the port's own
SMPL-X and FLAME assets, which the port builds from the same files or seed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.smplx.structs import SMPLXAssets
from .model import FitStatics
from .params import LEAVES, FittingParams, scatter_winners


def fitting_params_from_jax(leaves: Mapping[str, np.ndarray], device="cuda") -> FittingParams:
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return FittingParams(**{k: t(leaves[k]) for k in LEAVES})


_INT_TABLES = ("face_vertex_idx", "extra_joint_ids", "flame_lap_idx", "flip_closest_faces",
               "right_joint_idx", "left_joint_idx", "spine_joint_idx", "hand_joint_idx")
_FLOAT_TABLES = ("flame_lap_w", "flame_is_not_neck", "flip_bc")


def fit_statics_from_numpy(tables: Mapping, smplx_assets: SMPLXAssets,
                           flame_assets: SMPLXAssets) -> FitStatics:
    """The port's statics on the SMPL-X assets' device."""
    dev = smplx_assets.v_template.device
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dev, dt)
    fv = np.asarray(tables["face_vertex_idx"], np.int64)
    return FitStatics(
        smplx_assets=smplx_assets, flame_assets=flame_assets,
        face_winners=tuple(t(w, torch.int64) for w in scatter_winners(fv)),
        lear_vertex_idx=int(tables["lear_vertex_idx"]),
        rear_vertex_idx=int(tables["rear_vertex_idx"]),
        **{k: t(tables[k], torch.int64) for k in _INT_TABLES},
        **{k: t(tables[k], torch.float32) for k in _FLOAT_TABLES},
    )
