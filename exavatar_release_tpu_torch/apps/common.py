"""Shared app plumbing: build a full avatar setup from a subject directory
(counterpart of exavatar_release_tpu/apps/common.py).

With ``--human_model_path`` the apps load the released SMPL-X/FLAME files
and their correspondence tables from it, and render the face with FLAME's
topology and UV atlas; without it they run the synthetic body. Images are
read as data/subject.py reads them (the native PNG decoder; cv2 only where
the caller asks or the decoder does not take a file).
"""
from __future__ import annotations

import logging
import os.path as osp
from typing import Optional

import numpy as np
import torch

from ..avatar import scene as sc
from ..avatar.config import AvatarConfig
from ..avatar.human import HumanGaussians, init_human_buffers
from ..avatar.model import AvatarTrainables, FrameData, build_statics
from ..avatar.param_dict import init_param_frames
from ..core.camera import Camera
from ..data.subject import SubjectData, read_rgb
from ..models.smplx import (
    SMPLXIDInfo,
    build_prior,
    load_flame_assets,
    load_flame_uv,
    load_prior_tables,
    load_smplx_assets,
    synthetic_flame_assets,
    synthetic_smplx_assets,
)
from ..models.smplx.prior import REAL_LIP_VERTEX_IDX
from ..ops.lpips import init_lpips_random, load_lpips
from ..train.loop import ModelBundle


def resolve_lpips(lpips_weights: Optional[str], net: str = "vgg", quiet: bool = False,
                  device="cuda"):
    """Load LPIPS weights converted to the ``.npz`` layout, or fall back LOUDLY
    to seeded random weights.

    The reference's perceptual loss is pretrained-VGG LPIPS
    (avatar/common/nets/loss.py:80-97); results are not reference-comparable
    with random features, so the fallback is a WARNING, and a
    *given-but-missing* path is an error rather than a silent downgrade.
    """
    if lpips_weights is not None:
        if not osp.exists(lpips_weights):
            raise FileNotFoundError(
                f"--lpips_weights {lpips_weights!r} does not exist; refusing to silently fall "
                "back to random LPIPS features")
        return load_lpips(lpips_weights, device)
    if not quiet:  # test/animate paths never evaluate the LPIPS loss
        logging.getLogger("exavatar").warning(
            "LPIPS running with RANDOM %s weights (no --lpips_weights given). Loss values and "
            "eval metrics are NOT comparable to the reference.", net)
    return init_lpips_random(1, net, device)


def synthetic_face_mesh(prior):
    """FLAME-equivalent face mesh for synthetic assets (SMPL-X faces fully
    inside the face region, re-indexed over face_vertex_idx order):
    (faces, vertex uv, face uv)."""
    fv = prior.face_vertex_idx.cpu().numpy()
    faces = prior.assets.faces.cpu().numpy()
    inv = -np.ones(prior.assets.num_vertices, np.int64)
    inv[fv] = np.arange(fv.size)
    inside = (inv[faces] >= 0).all(axis=1)
    face_faces = inv[faces[inside]].astype(np.int32)
    if face_faces.size == 0:
        face_faces = np.zeros((1, 3), np.int32)
    pts = prior.assets.v_template.cpu().numpy()[fv]
    lo, hi = pts.min(0), pts.max(0)
    uv = ((pts[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)).astype(np.float32)
    return face_faces, uv, face_faces


def face_mesh_for(human_model_path: Optional[str], prior):
    """The face mesh for the face render, (faces, vertex uv, face uv): FLAME's
    topology and UV atlas under a ``human_model_path``, else the synthetic
    placeholder."""
    if human_model_path is not None:
        flame = load_flame_assets(human_model_path, device="cpu")
        vertex_uv, face_uv = load_flame_uv(human_model_path)
        return flame.faces.numpy(), vertex_uv, face_uv
    return synthetic_face_mesh(prior)


# the synthetic body's size, the JAX package's default
SYNTHETIC_BODY = {"rings": 16, "segs": 24}


def build_fit_statics_for(human_model_path: Optional[str], device="cuda"):
    """Fitting statics from the released SMPL-X/FLAME files and their
    correspondence tables (``smplx/smplx_flip_correspondences.npz`` among
    them) under a ``human_model_path``, else from the synthetic body
    (``SYNTHETIC_BODY``) and a synthetic FLAME head with as many expression
    coefficients (the expression space is shared by the two models)."""
    from ..fitting.model import build_fit_statics

    if human_model_path:
        tables = load_prior_tables(human_model_path)
        flip = np.load(osp.join(human_model_path, "smplx", "smplx_flip_correspondences.npz"))
        return build_fit_statics(
            load_smplx_assets(human_model_path, "male", device=device),
            load_flame_assets(human_model_path, device=device), tables["face_vertex_idx"],
            flip["closest_faces"], flip["bc"])
    smplx_assets = synthetic_smplx_assets(**SYNTHETIC_BODY, device=device)
    flame_assets, _ = synthetic_flame_assets(num_expr=smplx_assets.num_expr, device=device)
    fv = build_prior(smplx_assets).face_vertex_idx.cpu().numpy()
    Vf = flame_assets.num_vertices
    fv = np.concatenate([fv, np.tile(fv[-1:], max(0, Vf - fv.size))])[:Vf]
    return build_fit_statics(smplx_assets, flame_assets, fv)


def build_prior_for(human_model_path: Optional[str], gender: str = "male", device="cuda"):
    """The prior of the released assets and tables under an existing
    ``human_model_path``, else of the synthetic body (``SYNTHETIC_BODY``)."""
    if human_model_path is not None and osp.exists(human_model_path):
        assets = load_smplx_assets(human_model_path, gender, device=device)
        tables = load_prior_tables(human_model_path)
        return build_prior(assets, lip_vertex_idx=REAL_LIP_VERTEX_IDX,
                           face_vertex_idx=tables["face_vertex_idx"],
                           lhand_vertex_idx=tables["lhand_vertex_idx"],
                           rhand_vertex_idx=tables["rhand_vertex_idx"],
                           expr_vertex_idx=tables.get("expr_vertex_idx"))
    return build_prior(synthetic_smplx_assets(**SYNTHETIC_BODY, device=device))


def _fit_shape(x, shape):
    """An identity table at the prior's dimensions (real subjects always
    match; synthetic or partial ones get zero-padded)."""
    out = np.zeros(shape, np.float32)
    if x is not None:
        x = np.asarray(x, np.float32)
        if x.shape == shape:
            out = x
        elif len(x.shape) == len(shape):
            sl = tuple(slice(0, min(d, s)) for d, s in zip(x.shape, shape))
            out[sl] = x[sl]
    return out


def subject_bundle(subject: SubjectData, prior, cfg: AvatarConfig, flame_faces: np.ndarray,
                   flame_vertex_uv: np.ndarray, flame_face_uv: np.ndarray,
                   lpips_weights: Optional[str] = None, seed: int = 0,
                   lpips_quiet: bool = False, use_cv2: bool = False):
    """(trainables, scene_state, bundle, frame_rows) from a loaded subject, on
    the prior's device. The human's heads draw from a ``torch.Generator``
    seeded with ``seed`` (the JAX package seeds its key the same way; the
    numbers differ, which is why a checkpoint carries the weights across)."""
    a = prior.assets
    dev = a.v_template.device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    id_info = SMPLXIDInfo(
        shape_param=t(_fit_shape(subject.shape_param, (a.num_shape,))),
        face_offset=t(_fit_shape(subject.face_offset, (a.num_vertices, 3))),
        joint_offset=t(_fit_shape(subject.joint_offset, (a.num_joints, 3))),
        locator_offset=t(_fit_shape(subject.locator_offset, (a.num_joints, 3))),
    )
    human = HumanGaussians(cfg, a.num_shape, a.num_joints,
                           generator=torch.Generator(device="cpu").manual_seed(seed), device=dev)
    with torch.no_grad():
        human.shape_param.copy_(id_info.shape_param)
        human.joint_offset.copy_(id_info.joint_offset)
    buffers = init_human_buffers(prior)
    statics = build_statics(prior, buffers, flame_faces, flame_vertex_uv, flame_face_uv)

    pts = subject.scene_points
    scene_state = sc.init_from_point_cloud(t(pts[:, :3]), t(pts[:, 3:6]),
                                           t(subject.cam_dist_translate),
                                           float(subject.cam_dist_radius), cfg.scene_capacity)

    unique_frames = sorted(set(subject.frame_ids))
    frame_row_of = {f: i for i, f in enumerate(unique_frames)}
    trainables = AvatarTrainables(
        scene_state.params, human,
        init_param_frames([subject.smplx_params[f] for f in unique_frames], device=dev))

    if subject.face_texture_path is not None:
        tex = t(read_rgb(subject.face_texture_path, use_cv2))
        texm = t(read_rgb(subject.face_texture_mask_path, use_cv2)[2:3])  # cv2's channel 0
    else:
        tex = torch.full((3, 16, 16), 0.5, device=dev)
        texm = torch.ones(1, 16, 16, device=dev)

    bundle = ModelBundle(
        buffers=buffers, prior=prior, statics=statics, id_info=id_info,
        lpips=resolve_lpips(lpips_weights, "vgg", quiet=lpips_quiet, device=dev),
        face_texture=tex, face_texture_mask=texm, init_joint_offset=id_info.joint_offset,
    )
    return trainables, scene_state, bundle, frame_row_of


def frame_to_device(arrs, device) -> FrameData:
    """A frame of ``load_frame_arrays`` (with its ``frame_row``) on ``device``."""
    cp = arrs["cam_param"]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return FrameData(img=t(arrs["img"]), mask=t(arrs["mask"]), bbox=t(arrs["bbox"]),
                     cam=Camera(t(cp["R"]), t(cp["t"]), t(cp["focal"]), t(cp["princpt"])),
                     frame_row=int(arrs["frame_row"]))


def add_common_args(ap) -> None:
    """The options every avatar CLI of the port shares with the JAX package's,
    plus ``--device``."""
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--human_model_path", default=None)
    ap.add_argument("--scene_capacity", type=int, default=1 << 17)
    ap.add_argument("--triplane_ch", type=int, default=32)
    ap.add_argument("--triplane_res", type=int, default=128)
    ap.add_argument("--raster_backend", default="pallas", choices=["pallas", "ref"],
                    help="pallas: the hand-written CUDA kernels (their plain versions on the "
                         "CPU); ref: the dense plain forward under autograd")
    ap.add_argument("--pair_major", action="store_true",
                    help="ragged pair-major compositing — the right mode at reference avatar "
                         "density (no per-tile capacity, no truncation)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, where the kernels' plain versions run")


def settings_from_args(args):
    """The rasterizer settings of a CLI's ``--raster_backend`` and ``--pair_major``."""
    from ..ops.rasterizer.api import RasterizeSettings

    backend = "ref" if args.raster_backend == "ref" else "cuda"
    return RasterizeSettings(backend=backend, pair_major=args.pair_major)
