"""Preprocessing orchestrator (counterpart of
exavatar_release_tpu/apps/preprocess.py; reference fitting/tools/run.py:36-120).

Chains the per-subject preprocessing:
  frames -> [COLMAP | virtual cams] -> external detectors (DECA, Hand4Whole,
  mmpose, SAM, Depth-Anything) -> fit -> unwrap -> smooth -> background cloud.

External model-zoo detectors are pluggable CPU/GPU commands supplied by the
user (SURVEY.md §2 C24: the reference also shells out to separately-cloned
repos); this framework consumes their JSON/png outputs. Steps whose tool is
absent are skipped with a warning so partially-prepared subjects still
progress. The fit and unwrap CLIs run in this process (``apps.fit.main``,
``apps.unwrap.main``) on ``--device``, as do the built-in detector drivers'
networks and the background cloud's math; without ``--device cpu`` the run
needs a card and stops before any step where there is none.

    python -m exavatar_release_tpu_torch.apps.preprocess --subject_root <dir>
        [--human_model_path <dir>] [--use_colmap] [--colmap_bin colmap]
        [--smooth_length 9] [--skip_fit] [--no_vis] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import subprocess
import time
import traceback
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def run_colmap(subject_root: str, colmap_bin: str) -> bool:
    """COLMAP CLI chain (reference fitting/tools/run_colmap.py:35-42)."""
    if shutil.which(colmap_bin) is None:
        print(f"[preprocess] {colmap_bin} not found; skipping COLMAP")
        return False
    img_dir = osp.join(subject_root, "images")
    db = osp.join(subject_root, "colmap.db")
    sparse = osp.join(subject_root, "sparse_raw")
    os.makedirs(sparse, exist_ok=True)
    cmds = [
        [colmap_bin, "feature_extractor", "--database_path", db, "--image_path", img_dir],
        [colmap_bin, "exhaustive_matcher", "--database_path", db],
        [colmap_bin, "mapper", "--database_path", db, "--image_path", img_dir,
         "--output_path", sparse],
        [colmap_bin, "model_converter", "--input_path", osp.join(sparse, "0"),
         "--output_path", osp.join(subject_root, "sparse"), "--output_type", "TXT"],
    ]
    os.makedirs(osp.join(subject_root, "sparse"), exist_ok=True)
    for cmd in cmds:
        subprocess.run(cmd, check=True)
    return True


def make_virtual_cams(subject_root: str, focal: float = 2000.0):
    """Identity-rotation virtual cameras (reference
    fitting/tools/make_virtual_cam_params.py:26-27: R=I, f=2000, principal
    point at the image center), one per ``images/*.png``: a subject that has
    only ``frames/`` gets none, as in the JAX package."""
    import cv2

    os.makedirs(osp.join(subject_root, "cam_params"), exist_ok=True)
    for p in glob(osp.join(subject_root, "images", "*.png")):
        fid = osp.basename(p).split(".")[0]
        h, w = cv2.imread(p).shape[:2]
        payload = {
            "R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0],
            "focal": [focal, focal], "princpt": [w / 2.0, h / 2.0],
        }
        with open(osp.join(subject_root, "cam_params", f"{fid}.json"), "w") as f:
            json.dump(payload, f)


def run_external(name: str, cmd_tmpl: str, subject_root: str) -> bool:
    """Run a user-supplied external detector command (SAM / DECA /
    Hand4Whole / mmpose / Depth-Anything equivalents)."""
    if not cmd_tmpl:
        print(f"[preprocess] no command configured for {name}; skipping "
              f"(expects its outputs to already exist)")
        return False
    cmd = cmd_tmpl.format(subject_root=subject_root)
    print(f"[preprocess] {name}: {cmd}")
    subprocess.run(cmd, shell=True, check=True)
    return True


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """The preprocessing CLI. Returns ``seconds`` (host seconds of each step
    that ran), the fit CLI's records (``fit``, None when skipped) and the
    unwrap's coverage (``coverage``, None when it failed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--human_model_path", default=None)
    ap.add_argument("--use_colmap", action="store_true")
    ap.add_argument("--colmap_bin", default="colmap")
    ap.add_argument("--sam_cmd", default="")
    ap.add_argument("--sam_checkpoint", default="sam_vit_h_4b8939.pth")
    ap.add_argument("--sam_model_type", default="vit_h")
    ap.add_argument("--deca_cmd", default="")
    ap.add_argument("--hand4whole_cmd", default="")
    ap.add_argument("--mmpose_cmd", default="")
    ap.add_argument("--depth_cmd", default="")
    ap.add_argument("--depth_checkpoint", default="checkpoints/depth_anything_v2_vitl.pth")
    ap.add_argument("--depth_encoder", default="vitl")
    ap.add_argument("--smooth_length", type=int, default=9)
    ap.add_argument("--skip_fit", action="store_true")
    ap.add_argument("--no_vis", action="store_true",
                    help="skip the smoothed-parameter check video")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    root, dev = args.subject_root, args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"preprocess --device {dev} needs a CUDA device and there is none; "
                           f"pass --device cpu to run on the CPU")
    hm = ["--human_model_path", args.human_model_path] if args.human_model_path else []
    out: Dict[str, object] = {"seconds": {}, "fit": None, "coverage": None}
    t_step = [time.perf_counter()]

    def done(step):
        now = time.perf_counter()
        out["seconds"][step] = now - t_step[0]
        t_step[0] = now

    # 0. frames from video (reference fitting/tools/extract_frames.py)
    if osp.exists(osp.join(root, "video.mp4")) and not glob(osp.join(root, "frames", "*.png")):
        from .extract_frames import extract_frames

        n = extract_frames(root)
        print(f"[preprocess] extracted {n} frames from video.mp4")
        done("extract")

    # 1. cameras
    if args.use_colmap:
        run_colmap(root, args.colmap_bin)
    if not osp.exists(osp.join(root, "sparse", "cameras.txt")) and not glob(
        osp.join(root, "cam_params", "*.json")
    ):
        make_virtual_cams(root)
    done("cameras")

    # 2. external detectors (pluggable; outputs land in the reference layout)
    # mmpose runs FIRST: its keypoints_whole_body jsons prompt the SAM
    # masks below AND drive the whole fitting stage (reference
    # fitting/tools/run.py:74-81 runs it before fit.py)
    if args.mmpose_cmd:
        run_external("mmpose (keypoints_whole_body)", args.mmpose_cmd, root)
    else:
        # built-in whole-body keypoint driver (apps/run_mmpose.py) when
        # mmpose is importable; clean skip otherwise (import/load-scoped
        # guard — errors inside run_subject surface as themselves)
        mm_infer = None
        try:
            from . import run_mmpose

            mm_infer = run_mmpose.load_mmpose_inferencer(device=dev)
        except ImportError:
            print("[preprocess] mmpose not importable and no --mmpose_cmd; "
                  "skipping whole-body keypoints")
        if mm_infer is not None:
            n = run_mmpose.run_subject(root, mm_infer, write_video=not args.no_vis)
            print(f"[preprocess] mmpose keypoints: {n} frames")
    done("mmpose")
    if args.sam_cmd:
        run_external("SAM masks", args.sam_cmd, root)
    else:
        # built-in keypoint-prompted SAM driver (apps/run_sam.py) when the
        # segment_anything package is importable; clean skip otherwise.
        # Only the import/load is guarded — an ImportError raised INSIDE
        # run_subject (e.g. cv2 missing) must surface as itself, and a
        # missing per-frame input mid-run must fail loudly rather than
        # silently leave partial masks the skip logic would never redo.
        predictor = None
        try:
            from . import run_sam

            predictor = run_sam.load_sam_predictor(args.sam_checkpoint, args.sam_model_type,
                                                   device=dev)
        except ImportError:
            print("[preprocess] segment_anything not importable and no "
                  "--sam_cmd; skipping SAM masks")
        except FileNotFoundError as e:
            print(f"[preprocess] SAM skipped (missing checkpoint): {e}")
        if predictor is not None:
            n = run_sam.run_subject(root, predictor, write_video=not args.no_vis)
            print(f"[preprocess] SAM masks: {n} frames")
    done("sam")
    run_external("DECA (flame_init)", args.deca_cmd, root)
    run_external("Hand4Whole (smplx_init)", args.hand4whole_cmd, root)

    # 3. fit, in this process
    if not args.skip_fit:
        from . import fit

        out["fit"] = fit.main(["--subject_root", root, "--device", dev] + hm)
        done("fit")

    # 4. unwrap the face texture from the fitted parameters; a failure is
    # reported and the run goes on (the JAX package's subprocess does so)
    from . import unwrap

    try:
        out["coverage"] = unwrap.main(["--subject_root", root, "--device", dev] + hm)
    except Exception as e:  # any failure of the unwrap CLI
        traceback.print_exc()
        print(f"[preprocess] unwrap failed ({e!r}); continuing")
    done("unwrap")

    # 5. smooth the fitted parameters in place
    from ..fitting.smooth import smooth_sequence

    param_dir = osp.join(root, "smplx_optimized", "smplx_params")
    files = sorted(glob(osp.join(param_dir, "*.json")),
                   key=lambda p: int(osp.basename(p).split(".")[0]))
    if files:
        seq = []
        for p in files:
            with open(p) as f:
                seq.append({k: np.asarray(v, np.float32) for k, v in json.load(f).items()})
        smoothed = smooth_sequence(seq, window_length=args.smooth_length)
        for p, s in zip(files, smoothed):
            with open(p, "w") as f:
                json.dump({k: np.asarray(v).tolist() for k, v in s.items()}, f)
        print(f"[preprocess] smoothed {len(files)} frames")
        done("smooth")

        if not args.no_vis:
            try:
                smooth_check_video(root, args.human_model_path, files, smoothed, dev)
            except Exception as e:  # the video is an instrument, not a gate
                traceback.print_exc()
                print(f"[preprocess] smooth check video failed ({e!r}); continuing")
            done("smooth_video")

    # 6. background point cloud from monocular depth — AFTER fit/smooth so
    # the metric alignment can render the fitted meshes_smoothed plys (the
    # reference runs its Depth-Anything shim after run.py for the same
    # reason, run_depth_anything.py:85-91)
    if args.depth_cmd:
        run_external("Depth-Anything (bkg_point_cloud)", args.depth_cmd, root)
    elif not osp.exists(osp.join(root, "bkg_point_cloud.txt")):
        depth_fn = None
        try:
            from . import run_depth_anything

            depth_fn = run_depth_anything.load_depth_model(args.depth_checkpoint,
                                                           args.depth_encoder, device=dev)
        except ImportError:
            print("[preprocess] depth_anything_v2 not importable and no "
                  "--depth_cmd; skipping bkg_point_cloud")
        except FileNotFoundError as e:
            print(f"[preprocess] Depth-Anything skipped (missing checkpoint): {e}")
        if depth_fn is not None:
            run_depth_anything.run_subject(root, depth_fn, write_video=not args.no_vis,
                                           device=dev)
    done("depth")

    print("[preprocess] done")
    return out


def smooth_check_video(root, human_model_path, files, smoothed, device="cuda"):
    """Re-render the SMOOTHED parameters on ``device``: per-frame meshes,
    overlay renders, and the side-by-side check video (reference
    fitting/tools/smooth_smplx_params.py:148-205)."""
    import cv2

    from ..data.subject import read_rgb
    from ..fitting.model import fit_offsets
    from ..fitting.params import init_fitting_params
    from ..utils.mesh_io import save_ply
    from ..utils.vis import render_mesh_overlay, write_video
    from .common import _fit_shape, build_fit_statics_for
    from .fit import _fit_vis_meshes

    statics = build_fit_statics_for(human_model_path, device)
    out_dir = osp.join(root, "smplx_optimized")
    a, fa = statics.smplx_assets, statics.flame_assets

    def load_json(name, shape):
        """An identity table of the fit at the statics' dimensions: zeros
        where it is missing, cut or zero-padded where its size differs (the
        JAX package's gathers clamp out-of-range rows instead)."""
        p = osp.join(out_dir, name)
        if not osp.exists(p):
            return np.zeros(shape, np.float32)
        with open(p) as f:
            return _fit_shape(np.asarray(json.load(f), np.float32).reshape(-1, *shape[1:]),
                              shape)

    shape = load_json("shape_param.json", (a.num_shape,))
    joint_offset = load_json("joint_offset.json", (a.num_joints, 3))
    locator_offset = load_json("locator_offset.json", (a.num_joints, 3))
    face_offset = load_json("face_offset.json", (fa.num_vertices, 3))

    E = fa.num_expr
    z3 = np.zeros(3, np.float32)
    flame_stub = [
        {"root_pose": z3, "neck_pose": z3, "jaw_pose": s["jaw_pose"],
         "leye_pose": s["leye_pose"], "reye_pose": s["reye_pose"],
         "expr": np.asarray(s["expr"], np.float32).reshape(-1)[:E],
         "trans": np.asarray(s["trans"], np.float32)}
        for s in smoothed
    ]
    params = init_fitting_params(smoothed, flame_stub, np.zeros(fa.num_shape), a.num_shape,
                                 fa.num_vertices, a.num_joints, device)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    params.smplx_shape = t(shape)
    params.joint_offset = t(joint_offset)
    params.locator_offset = t(locator_offset)
    params.face_offset = t(face_offset)

    meshes_dir = osp.join(out_dir, "meshes_smoothed")
    renders_dir = osp.join(out_dir, "renders_smoothed")
    os.makedirs(meshes_dir, exist_ok=True)
    os.makedirs(renders_dir, exist_ok=True)
    sfaces = a.faces.cpu().numpy()

    video_frames = []
    with torch.no_grad():
        offsets = fit_offsets(params, statics)
        for i, p in enumerate(files):
            fid = int(osp.basename(p).split(".")[0])
            mesh = _fit_vis_meshes(statics, params, offsets, i)[0]
            save_ply(osp.join(meshes_dir, f"{fid}_smplx.ply"), mesh.cpu().numpy(), sfaces)
            img_path = None
            for sub in ("images", "frames"):
                for ext in (".png", ".jpg"):
                    cand = osp.join(root, sub, f"{fid}{ext}")
                    if osp.exists(cand):
                        img_path = cand
                        break
                if img_path:
                    break
            cam_path = osp.join(root, "cam_params", f"{fid}.json")
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
        write_video(osp.join(root, "smplx_optimized_smoothed.mp4"), video_frames)
        print(f"[preprocess] smooth check video: {len(video_frames)} frames")


if __name__ == "__main__":
    main()
