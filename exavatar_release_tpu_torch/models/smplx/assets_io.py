"""Synthetic SMPL-X assets (counterpart of
exavatar_release_tpu/models/smplx/assets_io.py:synthetic_smplx_assets).

A deterministic, structurally faithful model (full 55-joint SMPL-X skeleton,
manifold ellipsoid mesh, landmark tables) made with numpy from a seed, so
every layer runs without licensed files. The numpy code is the reference's
own, so the arrays are bit-identical to the JAX package's. Loaders for the
released SMPL-X files are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .structs import SMPLX_NECK_KIN_CHAIN, SMPLX_PARENTS, SMPLXAssets


def _skeleton_rest_joints() -> np.ndarray:
    """Approximate SMPL-X rest skeleton (y-up, meters)."""
    J = {
        "Pelvis": (0.0, 0.0, 0.0),
        "L_Hip": (0.08, -0.05, 0.0),
        "R_Hip": (-0.08, -0.05, 0.0),
        "Spine_1": (0.0, 0.10, 0.0),
        "L_Knee": (0.10, -0.45, 0.0),
        "R_Knee": (-0.10, -0.45, 0.0),
        "Spine_2": (0.0, 0.22, 0.0),
        "L_Ankle": (0.10, -0.85, 0.0),
        "R_Ankle": (-0.10, -0.85, 0.0),
        "Spine_3": (0.0, 0.32, 0.0),
        "L_Foot": (0.10, -0.92, 0.10),
        "R_Foot": (-0.10, -0.92, 0.10),
        "Neck": (0.0, 0.50, 0.0),
        "L_Collar": (0.05, 0.45, 0.0),
        "R_Collar": (-0.05, 0.45, 0.0),
        "Head": (0.0, 0.62, 0.0),
        "L_Shoulder": (0.17, 0.45, 0.0),
        "R_Shoulder": (-0.17, 0.45, 0.0),
        "L_Elbow": (0.42, 0.45, 0.0),
        "R_Elbow": (-0.42, 0.45, 0.0),
        "L_Wrist": (0.66, 0.45, 0.0),
        "R_Wrist": (-0.66, 0.45, 0.0),
        "Jaw": (0.0, 0.58, 0.05),
        "L_Eye": (0.03, 0.65, 0.08),
        "R_Eye": (-0.03, 0.65, 0.08),
    }
    joints = list(J.values())
    # fingers: 5 fingers x 3 joints per hand, fanning out along +-x
    for sign in (1.0, -1.0):
        wrist = np.array([sign * 0.66, 0.45, 0.0])
        for f in range(5):
            z = (f - 2) * 0.015
            for k in range(3):
                joints.append(tuple(wrist + np.array([sign * 0.03 * (k + 1), 0.0, z])))
    return np.asarray(joints, np.float32)  # (55, 3)


def _uv_sphere(rings: int, segs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit UV sphere mesh: V = (rings-1)*segs + 2, manifold triangles."""
    verts = [np.array([0.0, 1.0, 0.0])]
    for r in range(1, rings):
        phi = np.pi * r / rings
        for s in range(segs):
            th = 2 * np.pi * s / segs
            verts.append(
                np.array(
                    [np.sin(phi) * np.cos(th), np.cos(phi), np.sin(phi) * np.sin(th)]
                )
            )
    verts.append(np.array([0.0, -1.0, 0.0]))
    verts = np.stack(verts).astype(np.float32)

    faces = []

    def ring_idx(r, s):
        return 1 + (r - 1) * segs + (s % segs)

    for s in range(segs):  # top cap
        faces.append([0, ring_idx(1, s + 1), ring_idx(1, s)])
    for r in range(1, rings - 1):  # quads
        for s in range(segs):
            a, b = ring_idx(r, s), ring_idx(r, s + 1)
            c, d = ring_idx(r + 1, s), ring_idx(r + 1, s + 1)
            faces.append([a, b, c])
            faces.append([b, d, c])
    bot = len(verts) - 1
    for s in range(segs):  # bottom cap
        faces.append([bot, ring_idx(rings - 1, s), ring_idx(rings - 1, s + 1)])
    return verts, np.asarray(faces, np.int32)


def _synthetic_arrays(
    rings: int = 16,
    segs: int = 24,
    num_shape: int = 16,
    num_expr: int = 8,
    num_static_lmk: int = 51,
    num_contour_lmk: int = 17,
    seed: int = 0,
) -> dict:
    """The numpy arrays of ``synthetic_smplx_assets``, keyed by field name."""
    rng = np.random.default_rng(seed)
    joints = _skeleton_rest_joints()
    J = joints.shape[0]

    sphere_v, faces = _uv_sphere(rings, segs)
    center = np.array([0.0, -0.1, 0.0], np.float32)
    radii = np.array([0.85, 1.0, 0.45], np.float32)
    v_template = sphere_v * radii[None, :] + center[None, :]
    V = v_template.shape[0]

    # skinning: softmax over -d^2/tau of vertex-joint distances, top-4 sparse
    d2 = ((v_template[:, None, :] - joints[None, :, :]) ** 2).sum(-1)  # (V, J)
    logits = -d2 / 0.02
    order = np.argsort(logits, axis=1)[:, ::-1]
    w = np.zeros((V, J), np.float32)
    rows = np.arange(V)[:, None]
    top = order[:, :4]
    lw = np.exp(logits[rows, top] - logits[rows, top[:, :1]])
    w[rows, top] = lw / lw.sum(1, keepdims=True)

    # joint regressor: inverse-distance weights over 6 nearest vertices
    jr = np.zeros((J, V), np.float32)
    dj = np.sqrt(d2.T)  # (J, V)
    near = np.argsort(dj, axis=1)[:, :6]
    jrows = np.arange(J)[:, None]
    inv = 1.0 / (dj[jrows, near] + 1e-3)
    jr[jrows, near] = inv / inv.sum(1, keepdims=True)

    scale = 0.01
    shapedirs = rng.normal(0, scale, (V, 3, num_shape)).astype(np.float32)
    posedirs = rng.normal(0, scale * 0.1, (9 * (J - 1), V * 3)).astype(np.float32)

    # face region: vertices whose nearest joint is Head/Jaw/L_Eye/R_Eye
    nearest = np.argmin(d2, axis=1)
    face_region = np.isin(nearest, [15, 22, 23, 24])
    expr_dirs = np.zeros((V, 3, num_expr), np.float32)
    expr_dirs[face_region] = rng.normal(0, scale, (face_region.sum(), 3, num_expr))

    pose_mean = np.zeros((J * 3,), np.float32)
    pose_mean[75:165] = rng.normal(0, 0.05, (90,))  # hands mean

    # landmark tables anchored on face-region triangles
    face_tris = np.where(face_region[faces].all(axis=1))[0]
    if face_tris.size == 0:
        face_tris = np.arange(min(64, faces.shape[0]))
    lmk_faces = rng.choice(face_tris, size=num_static_lmk, replace=True).astype(np.int32)
    lmk_bary = rng.dirichlet(np.ones(3), size=num_static_lmk).astype(np.float32)
    dyn_faces = rng.choice(face_tris, size=(79, num_contour_lmk), replace=True).astype(np.int32)
    dyn_bary = rng.dirichlet(np.ones(3), size=(79, num_contour_lmk)).astype(np.float32)

    return dict(
        v_template=v_template, shapedirs=shapedirs, expr_dirs=expr_dirs,
        posedirs=posedirs, joint_regressor=jr, lbs_weights=w,
        pose_mean=pose_mean, faces=faces, lmk_faces_idx=lmk_faces,
        lmk_bary_coords=lmk_bary, dyn_lmk_faces_idx=dyn_faces,
        dyn_lmk_bary_coords=dyn_bary,
    )


def synthetic_smplx_assets(
    rings: int = 16,
    segs: int = 24,
    num_shape: int = 16,
    num_expr: int = 8,
    num_static_lmk: int = 51,
    num_contour_lmk: int = 17,
    seed: int = 0,
    device="cuda",
) -> SMPLXAssets:
    """Deterministic synthetic SMPL-X-structured model on ``device``.

    Full 55-joint skeleton with the real parents table; a manifold ellipsoid
    body mesh; smooth distance-based skinning (argmax = nearest joint, so
    part masks behave like the real model); expression basis supported only
    on face-region vertices.
    """
    arrays = _synthetic_arrays(
        rings, segs, num_shape, num_expr, num_static_lmk, num_contour_lmk, seed
    )
    return SMPLXAssets(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        parents=SMPLX_PARENTS,
        neck_kin_chain=SMPLX_NECK_KIN_CHAIN,
    )
