"""COLMAP sparse-reconstruction text parsers (counterpart of
exavatar_release_tpu/data/colmap.py, numpy on the host as there).

Reads the cameras.txt / images.txt / points3D.txt layout the reference
consumes (reference avatar/data/NeuMan/NeuMan.py:35-106).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation (numpy, host-side)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def parse_cameras_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(focal (2,), princpt (2,)) — shared intrinsics (the reference keeps
    the last PINHOLE entry, NeuMan.py:36-43)."""
    focal = princpt = None
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            # CAMERA_ID MODEL WIDTH HEIGHT fx fy cx cy
            fx, fy, cx, cy = (float(v) for v in parts[4:8])
            focal = np.array([fx, fy], np.float32)
            princpt = np.array([cx, cy], np.float32)
    assert focal is not None, f"no camera rows in {path}"
    return focal, princpt


def parse_images_txt(path: str, ext: str = ".png") -> Dict[int, Dict[str, np.ndarray]]:
    """frame_idx -> {R (3,3), t (3,)} world->camera extrinsics
    (NeuMan.py:44-58: frame index parsed from the image file name)."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            if ext not in line:
                continue
            parts = line.split()
            name = parts[-1]
            frame_idx = int(name[: -len(ext)].split("/")[-1])
            q = np.array([float(v) for v in parts[1:5]], np.float64)
            t = np.array([float(v) for v in parts[5:8]], np.float32)
            out[frame_idx] = {"R": _quat_to_matrix(q), "t": t}
    return out


def parse_points3d_txt(path: str, z_quantile: float = 0.95) -> np.ndarray:
    """(N, 6) [xyz, rgb in 0..1], z-outliers beyond the quantile removed
    (NeuMan.py:92-104)."""
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            p = line.split()
            rows.append(
                [float(p[1]), float(p[2]), float(p[3]),
                 float(p[4]) / 255.0, float(p[5]) / 255.0, float(p[6]) / 255.0]
            )
    pts = np.asarray(rows, np.float32)
    if z_quantile is not None and len(pts):
        keep = pts[:, 2] < np.quantile(pts[:, 2], z_quantile)
        pts = pts[keep]
    return pts
