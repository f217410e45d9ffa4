"""Fitting model: SMPL-X + FLAME forwards, keypoint losses, couplings
(counterpart of exavatar_release_tpu/fitting/model.py).

Functional equivalent of the reference fitting Model
(reference fitting/main/model.py:13-279): per frame it evaluates the SMPL-X
mesh (with/without face offset, with/without pose+expr) and the FLAME mesh,
projects 135 whole-body keypoints into the normalized supervision space,
gates face losses by visibility, and assembles ~20 loss terms with the stage
flags (warmup, hand joint offset) as host booleans.

The frames go through ``torch.func.vmap`` of the per-frame function, as JAX
maps them with ``jax.vmap``: every operation of ``smplx_forward`` and
``flame_forward`` (one sample each) runs once for the whole batch. What does
not depend on the frame (the padded and weighted offsets, the shape
regularizers) is computed once, unbatched; each ``jax.lax.stop_gradient`` of
the JAX function is a ``.detach()`` or a ``torch.no_grad()`` block here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..avatar.losses import (
    abs_as_jax,
    build_laplacian_neighbors,
    joint_offset_symmetric_reg,
    laplacian,
    symmetric_joint_pairs,
)
from ..core.rotations import rotation_6d_to_axis_angle
from ..models.smplx.flame import FLAMEParams, flame_forward
from ..models.smplx.model import smplx_forward
from ..models.smplx.prior import JOINT_PART
from ..models.smplx.structs import SMPLX_JOINT_NAMES, SMPLXAssets, SMPLXParams
from . import losses as FL
from .keypoints import KPT_PART_IDX, KPT_ROOT_IDX, SMPLX_KPT_NAMES, extra_joint_ids_for, \
    full_keypoints
from .params import (
    FittingParams,
    pad_face_offset,
    scatter_winners,
    weight_joint_offset,
    weight_locator_offset,
)


class FitFrameData(NamedTuple):
    """Per-frame supervision (reference dataset payload); every field leads
    with the batch F when frames are stacked."""

    kpt_img: torch.Tensor  # (135, 2) detected keypoints, normalized space
    kpt_valid: torch.Tensor  # (135, 1)
    focal_proj: torch.Tensor  # (2,) camera of the normalized space
    princpt_proj: torch.Tensor  # (2,)
    flame_valid: torch.Tensor  # () bool — DECA init exists for this frame
    # initial estimates (Hand4Whole / DECA), axis-angle
    init_smplx_pose: torch.Tensor  # (55, 3) full pose in joint order
    init_flame_pose: torch.Tensor  # (4, 3) neck/jaw/leye/reye
    init_flame_shape: torch.Tensor  # (S_f,)
    init_flame_expr: torch.Tensor  # (E,)


@dataclasses.dataclass(frozen=True)
class FitStatics:
    """Static tables for the fitting losses."""

    smplx_assets: SMPLXAssets
    flame_assets: SMPLXAssets
    face_vertex_idx: torch.Tensor  # (V_flame,) into SMPL-X verts
    face_winners: Tuple[torch.Tensor, torch.Tensor]  # scatter_winners(face_vertex_idx)
    extra_joint_ids: torch.Tensor  # (21,)
    flame_lap_idx: torch.Tensor  # (V_flame, 10)
    flame_lap_w: torch.Tensor
    flame_is_not_neck: torch.Tensor  # (V_flame, 1) float
    flip_closest_faces: torch.Tensor  # (V_smplx, 3)
    flip_bc: torch.Tensor  # (V_smplx, 3)
    right_joint_idx: torch.Tensor
    left_joint_idx: torch.Tensor
    spine_joint_idx: torch.Tensor  # joints regularized against kyphosis
    hand_joint_idx: torch.Tensor  # lhand+rhand joint rows
    lear_vertex_idx: int = 0
    rear_vertex_idx: int = 0


def build_fit_statics(
    smplx_assets: SMPLXAssets,
    flame_assets: SMPLXAssets,
    face_vertex_idx: np.ndarray,
    flip_closest_faces: Optional[np.ndarray] = None,
    flip_bc: Optional[np.ndarray] = None,
    lear_vertex_idx: int = 0,
    rear_vertex_idx: int = 0,
) -> FitStatics:
    """The tables, on the SMPL-X assets' device."""
    dev = smplx_assets.v_template.device
    V_f = flame_assets.num_vertices
    lap_idx, lap_w = build_laplacian_neighbors(flame_assets.faces.cpu().numpy(), V_f)
    not_neck = np.ones((V_f, 1), np.float32)
    # neck = verts dominated by the FLAME root joint (reference
    # model.py:221-223 uses lbs argmax == root)
    dom = flame_assets.lbs_weights.cpu().numpy().argmax(1)
    not_neck[dom == 0] = 0.0
    if flip_closest_faces is None:
        flip_closest_faces, flip_bc = FL.synthetic_flip_correspondence(
            smplx_assets.v_template.cpu().numpy(), smplx_assets.faces.cpu().numpy())
    r_idx, l_idx = symmetric_joint_pairs()
    spine_idx = [SMPLX_JOINT_NAMES.index(n)
                 for n in ("Spine_1", "Spine_2", "Spine_3", "Neck", "Head")]
    hand_idx = list(JOINT_PART["lhand"]) + list(JOINT_PART["rhand"])
    fv = np.asarray(face_vertex_idx, np.int64)
    t = lambda x, dt=torch.int64: torch.from_numpy(np.asarray(x)).to(dev, dt)
    return FitStatics(
        smplx_assets=smplx_assets,
        flame_assets=flame_assets,
        face_vertex_idx=t(fv),
        face_winners=tuple(t(w) for w in scatter_winners(fv)),
        extra_joint_ids=t(extra_joint_ids_for(smplx_assets)),
        flame_lap_idx=t(lap_idx),
        flame_lap_w=t(lap_w, torch.float32),
        flame_is_not_neck=t(not_neck, torch.float32),
        flip_closest_faces=t(flip_closest_faces),
        flip_bc=t(flip_bc, torch.float32),
        right_joint_idx=t(r_idx),
        left_joint_idx=t(l_idx),
        spine_joint_idx=t(spine_idx),
        hand_joint_idx=t(hand_idx),
        lear_vertex_idx=int(lear_vertex_idx),
        rear_vertex_idx=int(rear_vertex_idx),
    )


class FitOffsets(NamedTuple):
    """The identity offsets as ``smplx_forward`` takes them."""

    face: torch.Tensor  # (V, 3): pad_face_offset of the face offset
    joint: torch.Tensor  # (J, 3): weight_joint_offset
    locator: torch.Tensor  # (J, 3): weight_locator_offset


def fit_offsets(params: FittingParams, statics: FitStatics) -> FitOffsets:
    return FitOffsets(
        pad_face_offset(params.face_offset, statics.face_winners,
                        statics.smplx_assets.num_vertices),
        weight_joint_offset(params.joint_offset),
        weight_locator_offset(params.locator_offset),
    )


# the 6D leaves decoded per frame, with their joint counts
_POSE_LEAVES = (("smplx_root_pose", 1), ("smplx_body_pose", 21), ("jaw_pose", 1),
                ("leye_pose", 1), ("reye_pose", 1), ("smplx_lhand_pose", 15),
                ("smplx_rhand_pose", 15), ("flame_root_pose", 1), ("flame_neck_pose", 1))


def decode_poses(params: FittingParams, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Axis-angle of every 6D leaf at the frame ``rows``: {leaf: (F, 3) or
    (F, n, 3)}. One decode of all of them (the conversion is elementwise
    over leading dimensions, so it equals a decode per leaf)."""
    F = rows.shape[0]
    d6 = torch.cat([getattr(params, k)[rows].reshape(F, n, 6) for k, n in _POSE_LEAVES], dim=1)
    aa = torch.split(rotation_6d_to_axis_angle(d6), [n for _, n in _POSE_LEAVES], dim=1)
    return {k: a[:, 0] if n == 1 else a for (k, n), a in zip(_POSE_LEAVES, aa)}


def _frame_params(params: FittingParams, pose: Dict[str, torch.Tensor], expr: torch.Tensor
                  ) -> Tuple[SMPLXParams, FLAMEParams]:
    """One frame's model parameters from its decoded poses (translations zero:
    they are applied root-relative by the coords functions)."""
    z3 = torch.zeros(3, device=expr.device)
    sp = SMPLXParams(
        betas=params.smplx_shape, expr=expr, root_pose=pose["smplx_root_pose"],
        body_pose=pose["smplx_body_pose"], jaw_pose=pose["jaw_pose"],
        leye_pose=pose["leye_pose"], reye_pose=pose["reye_pose"],
        lhand_pose=pose["smplx_lhand_pose"], rhand_pose=pose["smplx_rhand_pose"], trans=z3,
    )
    fp = FLAMEParams(
        betas=params.flame_shape, expr=expr, root_pose=pose["flame_root_pose"],
        neck_pose=pose["flame_neck_pose"], jaw_pose=pose["jaw_pose"],
        leye_pose=pose["leye_pose"], reye_pose=pose["reye_pose"], trans=z3,
    )
    return sp, fp


def decode_frame(params: FittingParams, i: int) -> Tuple[SMPLXParams, FLAMEParams]:
    """Frame ``i``'s SMPL-X and FLAME parameters (the JAX ``_decode_frame``)."""
    rows = torch.tensor([i], device=params.expr.device)
    pose = {k: v[0] for k, v in decode_poses(params, rows).items()}
    return _frame_params(params, pose, params.expr[i])


def _project(kpt_cam, focal, princpt):
    x = kpt_cam[:, 0] / kpt_cam[:, 2] * focal[0] + princpt[0]
    y = kpt_cam[:, 1] / kpt_cam[:, 2] * focal[1] + princpt[1]
    return torch.stack([x, y], dim=1)


def smplx_coords(
    statics: FitStatics,
    sp: SMPLXParams,
    trans: torch.Tensor,
    offsets: FitOffsets,
    use_pose: bool = True,
    use_expr: bool = True,
    use_face_offset: bool = True,
    use_locator_offset: bool = True,
):
    """SMPL-X (mesh, keypoints), root-relative + trans (reference
    get_smplx_coord, model.py:56-122). The jaw, eye poses and expression are
    detached: they are optimized through the FLAME branch (reference
    model.py:95)."""
    a = statics.smplx_assets
    if not use_pose:
        z = lambda *shape: torch.zeros(shape, device=trans.device)
        sp = sp.replace(
            root_pose=z(3), body_pose=z(21, 3), jaw_pose=z(3), leye_pose=z(3),
            reye_pose=z(3), lhand_pose=z(15, 3), rhand_pose=z(15, 3),
        )
    if not use_expr:
        sp = sp.replace(expr=torch.zeros_like(sp.expr))
    sp = sp.replace(jaw_pose=sp.jaw_pose.detach(), leye_pose=sp.leye_pose.detach(),
                    reye_pose=sp.reye_pose.detach(), expr=sp.expr.detach())
    out = smplx_forward(
        a, sp, face_offset=offsets.face if use_face_offset else None, joint_offset=offsets.joint,
        locator_offset=offsets.locator if use_locator_offset else None,
        with_landmarks=True, use_face_contour=True,
    )
    kpt = full_keypoints(out, a, statics.extra_joint_ids)
    root = kpt[KPT_ROOT_IDX]
    return out.vertices - root[None] + trans[None], kpt - root[None] + trans[None]


def flame_coords(statics: FitStatics, fp: FLAMEParams, trans: torch.Tensor,
                 use_pose: bool = True, use_expr: bool = True):
    """FLAME mesh/keypoints (reference get_flame_coord, model.py:124-160)."""
    a = statics.flame_assets
    if not use_pose:
        z = torch.zeros(3, device=trans.device)
        fp = dataclasses.replace(fp, root_pose=z, neck_pose=z, jaw_pose=z, leye_pose=z,
                                 reye_pose=z)
    if not use_expr:
        fp = dataclasses.replace(fp, expr=torch.zeros_like(fp.expr))
    out = flame_forward(a, fp, with_landmarks=True)
    lear = out.vertices[statics.lear_vertex_idx][None]
    rear = out.vertices[statics.rear_vertex_idx][None]
    kpt = torch.cat([out.joints, out.landmarks, lear, rear], dim=0)
    root = kpt[0]  # FLAME kpt root = first joint (reference flame kpt root)
    mesh = out.vertices - root[None] + trans[None]
    kpt = kpt - root[None] + trans[None]
    return mesh, kpt


def check_face_visibility(face_mesh, leye, reye):
    """Eye-to-face-center direction vs camera direction in the xz plane
    (reference model.py:162-175): face counts as visible when looking
    broadly at the camera."""
    center = face_mesh.mean(0)
    eye = (leye + reye) / 2.0
    ev = eye - center
    ev2 = torch.stack([ev[0], ev[2]])
    cv2 = torch.stack([center[0], center[2]])
    ev2 = ev2 / torch.clamp(torch.linalg.norm(ev2), min=1e-12)
    cv2 = cv2 / torch.clamp(torch.linalg.norm(cv2), min=1e-12)
    return torch.sum(ev2 * cv2) < math.cos(math.pi / 4.0 * 3.0)


# the loss terms that count only after warm-up, in the JAX function's order
POST_TERMS = (
    "smplx_shape_reg", "smplx_mesh", "smplx_pose", "smplx_pose_reg", "flame_pose",
    "flame_shape", "flame_expr", "smplx_to_flame_v2v_wo_pose_expr", "smplx_to_flame_lap",
    "smplx_to_flame_edge_length", "face_offset_reg", "joint_offset_reg", "locator_offset_reg",
    "face_offset_sym_reg", "joint_offset_sym_reg", "locator_offset_sym_reg",
)


def fitting_forward(
    params: FittingParams,
    statics: FitStatics,
    frames: FitFrameData,  # leaves lead with batch F
    frame_rows: torch.Tensor,  # (F,) rows into params
    warmup: bool,
    hand_joint_offset: bool,  # lifts the hand joint-offset weight
) -> Dict[str, torch.Tensor]:
    """Loss dict over a frame batch (reference Model.forward,
    fitting/main/model.py:181-252). Scalar (already-meaned) terms; in warm-up
    the post terms are zeros and are not computed, after it the warm-up v2v
    term."""
    dev = params.expr.device
    rows = frame_rows.long()
    offsets = fit_offsets(params, statics)
    fv = statics.face_vertex_idx
    face_part = torch.tensor(KPT_PART_IDX["face"], device=dev)
    is_face_name = torch.tensor(["Face" in n for n in SMPLX_KPT_NAMES], device=dev)
    root_i = KPT_ROOT_IDX
    leye_i, reye_i = SMPLX_KPT_NAMES.index("L_Eye"), SMPLX_KPT_NAMES.index("R_Eye")
    z3 = torch.zeros(3, device=dev)

    def per_frame(pose, expr, s_trans, f_trans, frame: FitFrameData):
        sp, fp = _frame_params(params, pose, expr)
        mesh, kpt_cam = smplx_coords(statics, sp, s_trans, offsets)
        mesh_wo_fo, kpt_cam_wo_fo = smplx_coords(statics, sp, s_trans, offsets,
                                                    use_face_offset=False)
        f_mesh, f_kpt_cam = flame_coords(statics, fp, f_trans)

        kpt_proj = _project(kpt_cam, frame.focal_proj, frame.princpt_proj)
        kpt_proj_wo_fo = _project(kpt_cam_wo_fo, frame.focal_proj, frame.princpt_proj)
        f_kpt_proj = _project(f_kpt_cam, frame.focal_proj, frame.princpt_proj)

        # initial-parameter coordinates (detached; reference model.py:185-196)
        ip = frame.init_smplx_pose
        with torch.no_grad():
            sp_init = sp.replace(
                root_pose=ip[0], body_pose=ip[1:22], jaw_pose=ip[22], leye_pose=ip[23],
                reye_pose=ip[24], lhand_pose=ip[25:40], rhand_pose=ip[40:55],
            )
            mesh_init, kpt_cam_init = smplx_coords(statics, sp_init, s_trans, offsets,
                                                      use_face_offset=False)

        # keypoint weights (reference model.py:199-203): after warmup, face
        # keypoints count only when the face is visible
        if warmup:
            w = torch.ones(kpt_proj.shape[0], 1, device=dev)
        else:
            face_valid = check_face_visibility(mesh_init[fv], kpt_cam_init[leye_i],
                                               kpt_cam_init[reye_i]) & frame.flame_valid
            w = torch.where(is_face_name & ~face_valid, 0.0, 1.0)[:, None]

        losses = {}
        losses["smplx_kpt_proj"] = torch.mean(
            FL.coord_loss(kpt_proj, frame.kpt_img, frame.kpt_valid, kpt_cam) * w)
        losses["smplx_kpt_proj_wo_fo"] = torch.mean(
            FL.coord_loss(kpt_proj_wo_fo, frame.kpt_img, frame.kpt_valid, kpt_cam) * w)
        losses["flame_kpt_proj"] = torch.mean(
            abs_as_jax(f_kpt_proj - frame.kpt_img[face_part])
            * frame.kpt_valid[face_part] * w[face_part])

        # warmup: pull FLAME onto the SMPLX face; after: priors + couplings
        zero = torch.zeros((), device=dev)
        if warmup:
            losses["flame_to_smplx_v2v"] = torch.mean(abs_as_jax(f_mesh - mesh[fv].detach()))
            losses.update({k: zero for k in POST_TERMS})
            return losses
        losses["flame_to_smplx_v2v"] = zero

        # zero-pose meshes for the FLAME<->SMPLX shape couplings
        mesh_zero, _ = smplx_coords(statics, sp, z3, offsets, use_pose=False,
                                       use_expr=False, use_locator_offset=False)
        f_mesh_zero, _ = flame_coords(statics, fp, z3, use_pose=False, use_expr=False)
        f_mesh_zero = f_mesh_zero.detach()

        losses["smplx_shape_reg"] = torch.mean(params.smplx_shape ** 2) * 0.01
        losses["smplx_mesh"] = torch.mean(abs_as_jax(
            (mesh_wo_fo - kpt_cam_wo_fo[root_i][None])
            - (mesh_init - kpt_cam_init[root_i][None])
        )) * 0.1
        full_now = torch.cat(
            [sp.root_pose[None], sp.body_pose, sp.jaw_pose[None], sp.leye_pose[None],
             sp.reye_pose[None], sp.lhand_pose, sp.rhand_pose], dim=0)
        losses["smplx_pose"] = torch.mean(FL.pose_loss(full_now, frame.init_smplx_pose)) * 0.1
        losses["smplx_pose_reg"] = torch.mean(full_now[statics.spine_joint_idx, 0] ** 2)
        flame_pose_now = torch.stack([fp.neck_pose, fp.jaw_pose, fp.leye_pose, fp.reye_pose])
        losses["flame_pose"] = torch.mean(
            FL.pose_loss(flame_pose_now, frame.init_flame_pose)) * 0.1
        losses["flame_shape"] = torch.mean(
            abs_as_jax(params.flame_shape - frame.init_flame_shape)) * 0.1
        losses["flame_expr"] = torch.mean(abs_as_jax(expr - frame.init_flame_expr)) * 0.1

        nn = statics.flame_is_not_neck
        sm_face = mesh_zero[fv]
        losses["smplx_to_flame_v2v_wo_pose_expr"] = torch.mean(abs_as_jax(
            (sm_face - sm_face.mean(0)[None]) - (f_mesh_zero - f_mesh_zero.mean(0)[None])
        ) * nn) * 10.0
        lap_o = laplacian(sm_face, statics.flame_lap_idx, statics.flame_lap_w)
        lap_t = laplacian(f_mesh_zero, statics.flame_lap_idx, statics.flame_lap_w)
        losses["smplx_to_flame_lap"] = torch.mean(((lap_o - lap_t) ** 2) * nn) * 100000.0
        losses["smplx_to_flame_edge_length"] = torch.mean(
            FL.edge_length_loss(sm_face, f_mesh_zero, nn, statics.flame_assets.faces))

        losses["face_offset_reg"] = torch.mean(
            (offsets.face[fv] ** 2) * (1.0 - nn)) * 1000.0
        jw = torch.ones(statics.smplx_assets.num_joints, 1, device=dev)
        jw[statics.hand_joint_idx] = 1.0 if hand_joint_offset else 10.0
        losses["joint_offset_reg"] = torch.mean(params.joint_offset ** 2 * jw) * 100.0
        losses["locator_offset_reg"] = torch.mean(params.locator_offset ** 2)
        losses["face_offset_sym_reg"] = torch.mean(FL.face_offset_symmetric_reg(
            offsets.face, fv, statics.flip_closest_faces, statics.flip_bc))
        losses["joint_offset_sym_reg"] = joint_offset_symmetric_reg(
            params.joint_offset, statics.right_joint_idx, statics.left_joint_idx)
        losses["locator_offset_sym_reg"] = joint_offset_symmetric_reg(
            params.locator_offset, statics.right_joint_idx, statics.left_joint_idx)
        return losses

    per = torch.func.vmap(per_frame)(
        decode_poses(params, rows), params.expr[rows], params.smplx_trans[rows],
        params.flame_trans[rows], frames)
    # sorted, as JAX's vmap returns the dict: the total sums in this order
    return {k: torch.mean(per[k]) for k in sorted(per)}
