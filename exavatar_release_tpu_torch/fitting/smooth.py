"""Temporal smoothing of fitted SMPL-X parameter sequences (counterpart of
exavatar_release_tpu/fitting/smooth.py).

Equivalent of the reference smoothing tool (reference
fitting/tools/smooth_smplx_params.py:30-146): rotations go through
quaternion continuity fixing (sign-flip against the previous frame when the
dot product is negative) and a Savitzky-Golay filter (polyorder 2) in
quaternion space; translations/expressions are filtered directly.
Host-side numpy; the rotation conversions run on float32 CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from scipy.signal import savgol_filter

from ..core.rotations import axis_angle_to_quaternion, quaternion_to_axis_angle


def _f32(x: np.ndarray) -> torch.Tensor:
    """A float32 CPU tensor of ``x``, as ``jnp.asarray`` makes it."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def fix_quaternions(quats: np.ndarray) -> np.ndarray:
    """Enforce temporal sign continuity. quats: (F, N, 4)."""
    assert quats.ndim == 3 and quats.shape[-1] == 4
    result = quats.copy()
    dots = np.sum(quats[1:] * quats[:-1], axis=2)
    mask = dots < 0.0
    mask = (np.cumsum(mask, axis=0) % 2).astype(bool)
    result[1:][mask] *= -1.0
    return result


def smooth_poses(poses: np.ndarray, window_length: int) -> np.ndarray:
    """Smooth (F, N, 3) axis-angle series via quaternion S-G filtering
    (reference smoothen_poses, smooth_smplx_params.py:51-70)."""
    F, N, _ = poses.shape
    qs = axis_angle_to_quaternion(_f32(poses.reshape(-1, 3))).numpy()
    qs = qs.reshape(F, N, 4)
    qs = fix_quaternions(qs)
    qs_s = savgol_filter(qs, window_length=window_length, polyorder=2, axis=0)
    qs_s = qs_s / np.maximum(
        np.linalg.norm(qs_s, axis=-1, keepdims=True), 1e-12
    )
    out = quaternion_to_axis_angle(_f32(qs_s.reshape(-1, 4))).numpy()
    return out.reshape(F, N, 3)


def smooth_sequence(
    params_per_frame: Sequence[Dict[str, np.ndarray]],
    window_length: int = 9,
) -> Sequence[Dict[str, np.ndarray]]:
    """Smooth a whole fitted sequence (reference main loop,
    smooth_smplx_params.py:128-146): pose keys via quaternion S-G, linear
    keys (trans/expr) via direct S-G."""
    F = len(params_per_frame)
    if F < window_length:
        window_length = F if F % 2 == 1 else F - 1
    if window_length < 3:
        return list(params_per_frame)
    keys = params_per_frame[0].keys()
    out = [dict() for _ in range(F)]
    for key in keys:
        series = np.stack(
            [np.asarray(p[key], np.float32) for p in params_per_frame]
        )
        if "pose" in key:
            shaped = series.reshape(F, -1, 3)
            sm = smooth_poses(shaped, window_length)
            for i in range(F):
                out[i][key] = sm[i].reshape(series.shape[1:])
        elif key in ("trans", "expr"):
            sm = savgol_filter(series, window_length=window_length, polyorder=2, axis=0)
            for i in range(F):
                out[i][key] = sm[i]
        else:
            for i in range(F):
                out[i][key] = series[i]
    return out
