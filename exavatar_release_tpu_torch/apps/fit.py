"""SMPL-X/FLAME fitting CLI (counterpart of exavatar_release_tpu/apps/fit.py;
reference fitting/main/fit.py).

    python -m exavatar_release_tpu_torch.apps.fit --subject_root <dir>
        [--human_model_path <dir>] [--out_dir <dir>] [--batch_size 64] [--no_vis]
        [--device cuda|cpu]

Consumes the reference preprocessing outputs (keypoints_whole_body/,
smplx_init/, flame_init/, cam_params/) and writes smplx_optimized/ in the
reference layout the avatar stage reads. The check renders (``.jpg``
overlays and an mp4) are written with cv2: where cv2 is not installed the CLI
stops before fitting unless ``--no_vis`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """The fitting CLI. Returns one record per step: epoch, batch, itr,
    ``step_s`` (host seconds of the step's call) and the step's ``total`` and
    ``smplx_kpt_proj`` losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--human_model_path", default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--no_vis", action="store_true",
                    help="skip mesh/overlay/video dumps (reference fit.py "
                         "saves them unconditionally, fit.py:147-207)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not args.no_vis:
        try:
            import cv2  # noqa: F401  (the overlays and the check video)
        except ImportError:
            raise SystemExit("the fit check renders (.jpg overlays, smplx_optimized.mp4) need "
                             "cv2 (opencv-python), which is not installed: install it or pass "
                             "--no_vis")
    out_dir = args.out_dir or osp.join(args.subject_root, "smplx_optimized")
    dev = torch.device(args.device)

    from ..core.rotations import rotation_6d_to_axis_angle
    from ..fitting.config import FittingConfig
    from ..fitting.fit import (
        fit_step, init_fit_state, make_fit_optimizer, reinit_opt_on_stage_change, stage_flags,
    )
    from ..fitting.model import FitFrameData
    from ..fitting.params import init_fitting_params
    from ..utils.logging import make_logger
    from .common import build_fit_statics_for

    cfg = FittingConfig(batch_size=args.batch_size)
    logger = make_logger(osp.join(args.subject_root, "log"), "fit_logs.txt")
    statics = build_fit_statics_for(args.human_model_path, dev)

    # initial per-frame estimates (Hand4Whole smplx_init/, DECA flame_init/)
    def load_dir(name):
        out = {}
        for p in glob(osp.join(args.subject_root, name, "*.json")):
            stem = osp.basename(p).split(".")[0]
            if not stem.isdigit():  # e.g. flame_init/shape_param.json
                continue
            with open(p) as f:
                out[int(stem)] = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
        return out

    smplx_init = load_dir("smplx_init")
    flame_init = load_dir("flame_init")
    kpts = load_keypoints(args.subject_root)
    frame_ids = sorted(set(smplx_init) & set(kpts))
    assert frame_ids, "no frames with both smplx_init and keypoints"

    flame_shape = np.zeros(statics.flame_assets.num_shape, np.float32)
    shape_path = osp.join(args.subject_root, "flame_init", "shape_param.json")
    if osp.exists(shape_path):
        with open(shape_path) as f:
            loaded = np.asarray(json.load(f), np.float32).reshape(-1)
        n = min(loaded.size, flame_shape.size)
        flame_shape[:n] = loaded[:n]

    E = statics.flame_assets.num_expr

    def norm_flame(fid):
        d = flame_init.get(fid, {})
        z3 = np.zeros(3, np.float32)
        return {
            "root_pose": d.get("root_pose", z3), "neck_pose": d.get("neck_pose", z3),
            "jaw_pose": d.get("jaw_pose", z3), "leye_pose": d.get("leye_pose", z3),
            "reye_pose": d.get("reye_pose", z3),
            "expr": d.get("expr", np.zeros(E, np.float32))[:E],
            "trans": d.get("trans", np.asarray([0, 0, 1], np.float32)),
        }

    params = init_fitting_params(
        [smplx_init[f] for f in frame_ids], [norm_flame(f) for f in frame_ids], flame_shape,
        statics.smplx_assets.num_shape, statics.flame_assets.num_vertices,
        statics.smplx_assets.num_joints, dev)
    opt = make_fit_optimizer()
    state = init_fit_state(params, opt)

    # per-frame supervision in the normalized projection space
    proj_h, proj_w = cfg.proj_shape
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    frames_list = []
    for fid in frame_ids:
        k = kpts[fid]
        valid = (k[:, 2:3] > 0.5).astype(np.float32)
        # normalize keypoints into the proj space via their bbox
        xy = k[:, :2]
        v = valid[:, 0] > 0
        lo = xy[v].min(0) if v.any() else np.zeros(2)
        hi = xy[v].max(0) if v.any() else np.ones(2)
        span = np.maximum(hi - lo, 1e-3)
        xy_n = (xy - lo) / span * np.asarray([proj_w, proj_h])
        fi = norm_flame(fid)
        si = smplx_init[fid]
        full_pose = np.concatenate([
            si["root_pose"].reshape(1, 3), si["body_pose"].reshape(21, 3),
            fi["jaw_pose"].reshape(1, 3), fi["leye_pose"].reshape(1, 3),
            fi["reye_pose"].reshape(1, 3), si["lhand_pose"].reshape(15, 3),
            si["rhand_pose"].reshape(15, 3),
        ])
        frames_list.append(FitFrameData(
            kpt_img=t(xy_n), kpt_valid=t(valid),
            focal_proj=t([proj_w / 2.0, proj_h / 2.0]),
            princpt_proj=t([proj_w / 2.0, proj_h / 2.0]),
            flame_valid=torch.tensor(fid in flame_init, device=dev),
            init_smplx_pose=t(full_pose),
            init_flame_pose=t(np.stack([fi["neck_pose"], fi["jaw_pose"], fi["leye_pose"],
                                        fi["reye_pose"]])),
            init_flame_shape=t(flame_shape),
            init_flame_expr=t(fi["expr"]),
        ))

    history = []
    B = min(cfg.batch_size, len(frame_ids))
    for epoch in range(cfg.end_epoch):
        for b0 in range(0, len(frame_ids), B):
            rows = np.arange(b0, min(b0 + B, len(frame_ids)))
            batch = FitFrameData(*[torch.stack(xs) for xs in zip(*[frames_list[i] for i in rows])])
            rows_t = torch.from_numpy(rows).to(dev)
            prev_stage = None
            steps = []
            for itr in range(cfg.itr_opt_num(epoch)):
                lr, root_only, allow_shared, warmup, hjo = stage_flags(cfg, epoch, itr)
                state, prev_stage = reinit_opt_on_stage_change(
                    state, opt, prev_stage, (root_only, allow_shared))
                t0 = time.perf_counter()
                state, losses = fit_step(state, statics, batch, rows_t, opt, lr, root_only,
                                         allow_shared, warmup, hjo)
                steps.append((itr, time.perf_counter() - t0, losses["total"],
                              losses["smplx_kpt_proj"]))
                if itr % 50 == 0:
                    logger.info(f"epoch {epoch} batch {b0 // B} itr {itr} "
                                f"lr {lr:g} total {float(losses['total']):.4f}")
            vals = torch.stack([torch.stack(s[2:]) for s in steps]).tolist()
            history += [{"epoch": epoch, "batch": b0 // B, "itr": itr, "step_s": dt,
                         "total": v[0], "smplx_kpt_proj": v[1]}
                        for (itr, dt, *_), v in zip(steps, vals)]

    # save in the reference layout (reference fit.py:133-207)
    os.makedirs(osp.join(out_dir, "smplx_params"), exist_ok=True)
    p = state.params
    with torch.no_grad():
        aa = lambda x: rotation_6d_to_axis_angle(x).cpu().numpy().tolist()
        for i, fid in enumerate(frame_ids):
            payload = {
                "root_pose": aa(p.smplx_root_pose[i]),
                "body_pose": aa(p.smplx_body_pose[i]),
                "jaw_pose": aa(p.jaw_pose[i]),
                "leye_pose": aa(p.leye_pose[i]),
                "reye_pose": aa(p.reye_pose[i]),
                "lhand_pose": aa(p.smplx_lhand_pose[i]),
                "rhand_pose": aa(p.smplx_rhand_pose[i]),
                "expr": p.expr[i].cpu().numpy().tolist(),
                "trans": p.smplx_trans[i].cpu().numpy().tolist(),
            }
            with open(osp.join(out_dir, "smplx_params", f"{fid}.json"), "w") as f:
                json.dump(payload, f)
        for name, arr in (
            ("shape_param.json", p.smplx_shape),
            ("face_offset.json", p.face_offset),
            ("joint_offset.json", p.joint_offset),
            ("locator_offset.json", p.locator_offset),
        ):
            with open(osp.join(out_dir, name), "w") as f:
                json.dump(arr.cpu().numpy().tolist(), f)

        if not args.no_vis:
            _save_fit_vis(args, out_dir, statics, p, frame_ids, logger)
    logger.info(f"fitting results written to {out_dir}")
    return history


def load_keypoints(subject_root: str) -> Dict[int, np.ndarray]:
    """``keypoints_whole_body/<idx>.json`` in the SMPL-X 135-keypoint
    convention the fit supervises. A file of 133 rows is the detector's
    COCO-WholeBody order, which ``apps/run_mmpose.py`` writes: it is mapped by
    name (``fitting.kpt_convert.coco133_to_smplx135``, as the reference's
    Custom.py:21-28 does), where the JAX package's CLI would take it as it is
    and fail on its shape."""
    from ..fitting.kpt_convert import COCO_WHOLEBODY_133_NAMES, coco133_to_smplx135

    kpts = {}
    for p in glob(osp.join(subject_root, "keypoints_whole_body", "*.json")):
        with open(p) as f:
            k = np.asarray(json.load(f), np.float32)
        if k.shape[0] == len(COCO_WHOLEBODY_133_NAMES):
            k = coco133_to_smplx135(k)
        kpts[int(osp.basename(p).split(".")[0])] = k
    return kpts


def _save_fit_vis(args, out_dir, statics, p, frame_ids, logger):
    """Fit-time correctness instruments (reference fitting/main/fit.py:147-207):
    per-frame fitted SMPL-X/FLAME meshes, one-time canonical meshes, overlay
    renders over the video frames, and the side-by-side check video."""
    import cv2

    from ..data.subject import read_rgb
    from ..fitting.model import decode_frame, fit_offsets, flame_coords, smplx_coords
    from ..utils.mesh_io import save_ply
    from ..utils.vis import render_mesh_overlay, write_video

    meshes_dir = osp.join(out_dir, "meshes")
    renders_dir = osp.join(out_dir, "renders")
    os.makedirs(meshes_dir, exist_ok=True)
    os.makedirs(renders_dir, exist_ok=True)
    sfaces = statics.smplx_assets.faces.cpu().numpy()
    ffaces = statics.flame_assets.faces.cpu().numpy()
    offsets = fit_offsets(p, statics)
    np_ = lambda x: x.cpu().numpy()

    # one-time canonical meshes (reference fit.py:149-153)
    sp0, fp0 = decode_frame(p, 0)
    z3 = torch.zeros(3, device=p.expr.device)
    mesh_wo, _ = smplx_coords(statics, sp0, z3, offsets, use_pose=False, use_expr=False)
    save_ply(osp.join(out_dir, "smplx_wo_pose_wo_expr.ply"), np_(mesh_wo), sfaces)
    mesh_wo_fo, _ = smplx_coords(statics, sp0, z3, offsets, use_pose=False,
                                    use_expr=False, use_face_offset=False)
    save_ply(osp.join(out_dir, "smplx_wo_pose_wo_expr_wo_fo.ply"), np_(mesh_wo_fo), sfaces)
    fmesh_wo, _ = flame_coords(statics, fp0, z3, use_pose=False, use_expr=False)
    save_ply(osp.join(out_dir, "flame_wo_pose_wo_expr.ply"), np_(fmesh_wo), ffaces)

    video_frames = []
    for i, fid in enumerate(frame_ids):
        mesh, fmesh = _fit_vis_meshes(statics, p, offsets, i)
        save_ply(osp.join(meshes_dir, f"{fid}_smplx.ply"), np_(mesh), sfaces)
        save_ply(osp.join(meshes_dir, f"{fid}_flame.ply"), np_(fmesh), ffaces)

        img_path = None
        for ext in (".png", ".jpg"):
            cand = osp.join(args.subject_root, "images", f"{fid}{ext}")
            if osp.exists(cand):
                img_path = cand
                break
        cam_path = osp.join(args.subject_root, "cam_params", f"{fid}.json")
        if img_path is None or not osp.exists(cam_path):
            continue
        img = read_rgb(img_path).transpose(1, 2, 0)
        with open(cam_path) as f:
            camd = json.load(f)
        overlay = render_mesh_overlay(img, mesh, sfaces, camd["focal"], camd["princpt"])
        cv2.imwrite(osp.join(renders_dir, f"{fid}_smplx.jpg"),
                    (np.clip(overlay, 0, 1)[:, :, ::-1] * 255).astype(np.uint8))
        video_frames.append(np.concatenate([img, overlay], axis=1))

    if video_frames:
        write_video(osp.join(osp.dirname(out_dir) or ".", "smplx_optimized.mp4"), video_frames)
        logger.info(f"check video: {len(video_frames)} frames")


def _fit_vis_meshes(statics, p, offsets, i):
    """Frame ``i``'s fitted SMPL-X and FLAME meshes in camera space."""
    from ..fitting.model import decode_frame, flame_coords, smplx_coords

    sp, fp = decode_frame(p, i)
    mesh, _ = smplx_coords(statics, sp, p.smplx_trans[i], offsets)
    fmesh, _ = flame_coords(statics, fp, p.flame_trans[i])
    return mesh, fmesh


if __name__ == "__main__":
    main()
