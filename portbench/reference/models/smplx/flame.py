"""FLAME head model on torch tensors (counterpart of
exavatar_release_tpu/models/smplx/flame.py).

A 5-joint head skeleton (global, neck, jaw, eyes), shape and expression
bases, static and dynamic-contour landmarks and the UV tables, on the
generic LBS core (lbs.py) with the FLAME kinematic tree. The loaders read the
released files (``flame/FLAME_NEUTRAL.npz`` or ``generic_model.npz``, else
``generic_model.pkl``; the landmark embeddings; ``FLAME_texture.npz``) with
numpy and pickle as the JAX package does; ``synthetic_flame_assets`` builds
the JAX package's seeded test head with the same numpy calls, so its arrays
are bit-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.rotations import axis_angle_to_matrix
from .assets_io import SHAPE_SPACE_DIM, _uv_sphere
from .lbs import blend_shapes, lbs, neck_yaw_bucket, vertices_to_joints, vertices_to_landmarks
from .structs import SMPLXAssets, SMPLXOutput

FLAME_JOINT_NAMES: Tuple[str, ...] = ("Global", "Neck", "Jaw", "L_Eye", "R_Eye")
FLAME_PARENTS: Tuple[int, ...] = (-1, 0, 1, 1, 1)
FLAME_NECK_KIN_CHAIN: Tuple[int, ...] = (1,)  # neck rotation only


@dataclasses.dataclass(frozen=True)
class FLAMEParams:
    """One frame of FLAME parameters, axis-angle, no batch dim."""

    betas: torch.Tensor  # (S,)
    expr: torch.Tensor  # (E,)
    root_pose: torch.Tensor  # (3,) global orient
    neck_pose: torch.Tensor  # (3,)
    jaw_pose: torch.Tensor  # (3,)
    leye_pose: torch.Tensor  # (3,)
    reye_pose: torch.Tensor  # (3,)
    trans: torch.Tensor  # (3,)

    @staticmethod
    def zeros(num_shape: int = 100, num_expr: int = 50, device="cuda") -> "FLAMEParams":
        z = lambda n: torch.zeros(n, device=device)
        return FLAMEParams(betas=z(num_shape), expr=z(num_expr), root_pose=z(3),
                           neck_pose=z(3), jaw_pose=z(3), leye_pose=z(3), reye_pose=z(3),
                           trans=z(3))

    def full_pose(self) -> torch.Tensor:
        """(5, 3) axis-angle in FLAME joint order."""
        return torch.stack([self.root_pose, self.neck_pose, self.jaw_pose, self.leye_pose,
                            self.reye_pose], dim=0)


def flame_forward(
    assets: SMPLXAssets,
    params: FLAMEParams,
    face_offset: Optional[torch.Tensor] = None,
    with_landmarks: bool = True,
    use_face_contour: bool = True,
) -> SMPLXOutput:
    """FLAME forward (pip smplx's FLAME.forward semantics)."""
    shape_coeffs = torch.cat([params.betas, params.expr], dim=0)
    shapedirs = torch.cat([assets.shapedirs, assets.expr_dirs], dim=-1)
    v_template = assets.v_template
    if face_offset is not None:
        v_template = v_template + face_offset

    rot_mats = axis_angle_to_matrix(params.full_pose())
    verts, joints, A = lbs(shape_coeffs, rot_mats, v_template, shapedirs, assets.posedirs,
                           assets.joint_regressor, assets.parents, assets.lbs_weights)

    landmarks = None
    if with_landmarks:
        lmk_faces_idx = assets.lmk_faces_idx
        lmk_bary = assets.lmk_bary_coords
        if use_face_contour and assets.dyn_lmk_faces_idx.numel() > 0:
            bucket = neck_yaw_bucket(rot_mats, assets.neck_kin_chain)
            lmk_faces_idx = torch.cat([lmk_faces_idx, assets.dyn_lmk_faces_idx[bucket]], dim=0)
            lmk_bary = torch.cat([lmk_bary, assets.dyn_lmk_bary_coords[bucket]], dim=0)
        landmarks = vertices_to_landmarks(verts, assets.faces, lmk_faces_idx, lmk_bary)
        landmarks = landmarks + params.trans[None, :]

    v_shaped = assets.v_template + blend_shapes(params.betas, assets.shapedirs)
    joints_zero = vertices_to_joints(assets.joint_regressor,
                                     v_template + blend_shapes(shape_coeffs, shapedirs))
    return SMPLXOutput(
        vertices=verts + params.trans[None, :],
        joints=joints + params.trans[None, :],
        landmarks=landmarks,
        v_shaped=v_shaped,
        joints_zero_pose=joints_zero,
        rel_transforms=A,
    )


@dataclasses.dataclass(frozen=True)
class FLAMEPrior:
    """UV tables around FLAME assets: vertex_uv with v already flipped,
    face_uv indices into it."""

    assets: SMPLXAssets
    vertex_uv: torch.Tensor  # (Vt, 2) in [0, 1]
    face_uv: torch.Tensor  # (F, 3) int32

    @property
    def vertex_num(self) -> int:
        return self.assets.num_vertices


def _flame_assets(arrays: dict, device) -> SMPLXAssets:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SMPLXAssets(**{k: t(v) for k, v in arrays.items()}, parents=FLAME_PARENTS,
                       neck_kin_chain=FLAME_NECK_KIN_CHAIN)


def load_flame_assets(human_model_path: str, num_shape: int = 100, num_expr: int = 50,
                      device="cuda") -> SMPLXAssets:
    """Load released FLAME assets from ``human_model_path/flame`` (the npz
    model, or ``generic_model.pkl``, and the landmark embeddings where they
    are), as pip smplx builds them for the reference."""
    base = osp.join(human_model_path, "flame")
    model = None
    for name in ("FLAME_NEUTRAL.npz", "generic_model.npz"):
        p = osp.join(base, name)
        if osp.exists(p):
            model = dict(np.load(p, allow_pickle=True))
            break
    if model is None:
        with open(osp.join(base, "generic_model.pkl"), "rb") as f:
            model = pickle.load(f, encoding="latin1")

    arr = lambda x: np.asarray(x, np.float32)
    shapedirs_all = arr(model["shapedirs"])
    posedirs = arr(model["posedirs"])
    V = posedirs.shape[0]

    lmk_path = osp.join(base, "flame_static_embedding.pkl")
    dyn_path = osp.join(base, "flame_dynamic_embedding.npy")
    if osp.exists(lmk_path):
        with open(lmk_path, "rb") as f:
            static = pickle.load(f, encoding="latin1")
        lmk_faces = np.asarray(static["lmk_face_idx"], np.int32)
        lmk_bary = np.asarray(static["lmk_b_coords"], np.float32)
    else:
        lmk_faces, lmk_bary = np.zeros((0,), np.int32), np.zeros((0, 3), np.float32)
    if osp.exists(dyn_path):
        dyn = np.load(dyn_path, allow_pickle=True, encoding="latin1")[()]
        dyn_faces = np.asarray(dyn["lmk_face_idx"], np.int32)
        dyn_bary = np.asarray(dyn["lmk_b_coords"], np.float32)
    else:
        dyn_faces, dyn_bary = np.zeros((79, 0), np.int32), np.zeros((79, 0, 3), np.float32)

    J = len(FLAME_PARENTS)
    return _flame_assets(dict(
        v_template=arr(model["v_template"]),
        shapedirs=shapedirs_all[:, :, :num_shape],
        expr_dirs=shapedirs_all[:, :, SHAPE_SPACE_DIM:SHAPE_SPACE_DIM + num_expr],
        posedirs=posedirs.reshape(V * 3, -1).T,
        joint_regressor=arr(model["J_regressor"]),
        lbs_weights=arr(model["weights"]),
        pose_mean=np.zeros((J * 3,), np.float32),
        faces=np.asarray(model["f"], np.int32),
        lmk_faces_idx=lmk_faces, lmk_bary_coords=lmk_bary,
        dyn_lmk_faces_idx=dyn_faces, dyn_lmk_bary_coords=dyn_bary,
    ), device)


def load_flame_uv(human_model_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertex_uv (Vt, 2) f32 with v flipped, face_uv (F, 3) i32) of
    ``flame/FLAME_texture.npz``."""
    tex = np.load(osp.join(human_model_path, "flame", "FLAME_texture.npz"))
    vertex_uv = np.asarray(tex["vt"], np.float32).copy()
    face_uv = np.asarray(tex["ft"], np.int64).astype(np.int32)
    vertex_uv[:, 1] = 1.0 - vertex_uv[:, 1]
    return vertex_uv, face_uv


def synthetic_flame_assets(
    rings: int = 12,
    segs: int = 16,
    num_shape: int = 10,
    num_expr: int = 6,
    num_static_lmk: int = 51,
    num_contour_lmk: int = 17,
    seed: int = 1,
    device="cuda",
) -> Tuple[SMPLXAssets, FLAMEPrior]:
    """Deterministic synthetic FLAME-structured head for tests: sphere mesh,
    5-joint tree, spherical UV parameterization."""
    rng = np.random.default_rng(seed)
    sphere_v, faces = _uv_sphere(rings, segs)
    v_template = (sphere_v * np.array([0.09, 0.11, 0.10]) +
                  np.array([0.0, 0.0, 0.02])).astype(np.float32)
    V = v_template.shape[0]

    joints = np.array(
        [
            [0.0, -0.02, 0.0],  # global
            [0.0, -0.08, -0.01],  # neck
            [0.0, -0.04, 0.04],  # jaw
            [0.03, 0.03, 0.08],  # L eye
            [-0.03, 0.03, 0.08],  # R eye
        ],
        np.float32,
    )
    J = 5
    d2 = ((v_template[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    logits = -d2 / 0.004
    ex = np.exp(logits - logits.max(1, keepdims=True))
    w = (ex / ex.sum(1, keepdims=True)).astype(np.float32)

    jr = np.zeros((J, V), np.float32)
    near = np.argsort(d2.T, axis=1)[:, :6]
    jrows = np.arange(J)[:, None]
    inv = 1.0 / (np.sqrt(d2.T[jrows, near]) + 1e-3)
    jr[jrows, near] = inv / inv.sum(1, keepdims=True)

    scale = 0.004
    shapedirs = rng.normal(0, scale, (V, 3, num_shape)).astype(np.float32)
    expr_dirs = rng.normal(0, scale, (V, 3, num_expr)).astype(np.float32)
    posedirs = rng.normal(0, scale * 0.1, (9 * (J - 1), V * 3)).astype(np.float32)

    F = faces.shape[0]
    lmk_faces = rng.integers(0, F, num_static_lmk).astype(np.int32)
    lmk_bary = rng.dirichlet(np.ones(3), num_static_lmk).astype(np.float32)
    dyn_faces = rng.integers(0, F, (79, num_contour_lmk)).astype(np.int32)
    dyn_bary = rng.dirichlet(np.ones(3), (79, num_contour_lmk)).astype(np.float32)

    assets = _flame_assets(dict(
        v_template=v_template, shapedirs=shapedirs, expr_dirs=expr_dirs, posedirs=posedirs,
        joint_regressor=jr, lbs_weights=w, pose_mean=np.zeros((J * 3,), np.float32),
        faces=faces, lmk_faces_idx=lmk_faces, lmk_bary_coords=lmk_bary,
        dyn_lmk_faces_idx=dyn_faces, dyn_lmk_bary_coords=dyn_bary,
    ), device)

    # spherical UV: u = azimuth, v = polar angle (v-flip already applied)
    x, y, z = sphere_v[:, 0], sphere_v[:, 1], sphere_v[:, 2]
    u = (np.arctan2(z, x) / (2 * np.pi) + 0.5).astype(np.float32)
    vv = (np.arccos(np.clip(y, -1, 1)) / np.pi).astype(np.float32)
    prior = FLAMEPrior(assets=assets,
                       vertex_uv=torch.from_numpy(np.stack([u, vv], 1)).to(device),
                       face_uv=assets.faces)  # per-vertex UV: same topology
    return assets, prior
