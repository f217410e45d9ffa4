"""Monocular-depth background point cloud driver (counterpart of
exavatar_release_tpu/apps/run_depth_anything.py; the reference's
Depth-Anything shim, fitting/tools/code_to_copy/run_depth_anything.py:54-121,
reimplemented as a first-class app instead of copy-into-the-DA-repo glue).

Per frame under ``frames/``: predict a relative depth map, then — for frames
that already have a fitted SMPL-X mesh (``smplx_optimized/meshes_smoothed/
<idx>_smplx.ply``, camera-frame, written by apps/fit.py / preprocess) — render
the mesh's metric depth, rescale the relative prediction onto it (mean
absolute deviation matching), and accumulate the NON-human pixels
(``masks/<idx>.png``). The averaged background depth+color back-projects into
``bkg_point_cloud.txt``, the scene-Gaussian init the avatar stage consumes
when no COLMAP points exist (data/subject.py:141). All of that math is
data/depth_cloud.py's, on ``device`` (the card by default): the mesh depth
render, the alignment, the float64 accumulators and the back-projection;
this driver adds the network and the file plumbing, on the host over cv2.

The depth network is pluggable: by default this imports ``depth_anything_v2``
(and torch) only when actually run, so the module stays importable — and the
preprocess orchestrator can skip it cleanly — in environments without it. Any
callable mapping an RGB uint8 image to a (H, W) float32 relative depth with
LARGER = CLOSER (Depth-Anything's native disparity convention) can be
injected for testing or to call a remote endpoint. Deviation from the
reference: alignment runs on the float prediction directly instead of
round-tripping through the 8-bit grayscale PNG it saves (
run_depth_anything.py:77-93) — same math, minus the quantization.

    python -m exavatar_release_tpu_torch.apps.run_depth_anything --subject_root <dir>
        [--encoder vitl] [--checkpoint checkpoints/depth_anything_v2_vitl.pth]
        [--device cuda|cpu] [--no_video]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from glob import glob
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.depth_cloud import (
    BkgCloudAccumulator,
    align_depth_to_smplx,
    render_smplx_depth,
    save_bkg_point_cloud,
)
from ..utils.mesh_io import load_ply

DepthFn = Callable[[np.ndarray], np.ndarray]


def load_depth_model(checkpoint: str, encoder: str = "vitl", device: str = "cuda") -> DepthFn:
    """Build a real Depth-Anything-V2 predictor; raises ImportError when the
    package is absent (callers surface that as a skip)."""
    from depth_anything_v2.dpt import DepthAnythingV2

    cfgs = {
        "vits": {"encoder": "vits", "features": 64,
                 "out_channels": [48, 96, 192, 384]},
        "vitb": {"encoder": "vitb", "features": 128,
                 "out_channels": [96, 192, 384, 768]},
        "vitl": {"encoder": "vitl", "features": 256,
                 "out_channels": [256, 512, 1024, 1024]},
    }
    model = DepthAnythingV2(**cfgs[encoder])
    model.load_state_dict(torch.load(checkpoint, map_location="cpu"))
    model = model.to(device).eval()

    def predict(img_rgb: np.ndarray) -> np.ndarray:
        # infer_image takes BGR (it cvtColors internally)
        return np.asarray(
            model.infer_image(img_rgb[:, :, ::-1]), np.float32
        )

    return predict


def run_subject(subject_root: str, predict: DepthFn, write_video: bool = True,
                device="cuda") -> int:
    """Depth for every frame + background cloud accumulation (reference
    run_depth_anything.py:60-121), the cloud's math on ``device``. Returns
    the number of frames whose background contributed to the cloud (frames
    without a fitted mesh get a depth map but no accumulation, like the
    reference's ``continue``)."""
    import cv2

    dev = torch.device(device)
    on_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out_dir = osp.join(subject_root, "depthmaps")
    os.makedirs(out_dir, exist_ok=True)
    img_paths = glob(osp.join(subject_root, "frames", "*.png"))
    frame_ids = sorted(int(osp.basename(p)[:-4]) for p in img_paths)
    if not frame_ids:
        print(f"[run_depth_anything] no frames under {subject_root}/frames")
        return 0

    h, w = cv2.imread(
        osp.join(subject_root, "frames", f"{frame_ids[0]}.png")
    ).shape[:2]
    video = None
    if write_video:
        video = cv2.VideoWriter(
            osp.join(subject_root, "depthmaps.mp4"),
            cv2.VideoWriter_fourcc(*"mp4v"), 30, (w * 2, h),
        )

    accum = BkgCloudAccumulator((h, w), dev)
    cam_param = None
    n_accum = 0
    for idx in frame_ids:
        img = cv2.imread(osp.join(subject_root, "frames", f"{idx}.png"))
        rel = predict(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))

        # grayscale vis (close = bright, like the reference's --grayscale
        # outputs) + check video
        lo, hi = float(rel.min()), float(rel.max())
        gray = ((rel - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
        cv2.imwrite(osp.join(out_dir, f"{idx}.png"), gray)
        if video is not None:
            frame = np.concatenate(
                (img, np.repeat(gray[:, :, None], 3, axis=2)), 1
            )
            frame = cv2.putText(
                frame, str(idx), (int(w * 0.1), int(h * 0.1)),
                cv2.FONT_HERSHEY_PLAIN, 2.0, (0, 0, 255), 3,
            )
            video.write(frame.astype(np.uint8))

        mesh_path = osp.join(subject_root, "smplx_optimized",
                             "meshes_smoothed", f"{idx}_smplx.ply")
        cam_path = osp.join(subject_root, "cam_params", f"{idx}.json")
        mask_path = osp.join(subject_root, "masks", f"{idx}.png")
        if not (osp.isfile(mesh_path) and osp.isfile(cam_path)
                and osp.isfile(mask_path)):
            continue
        verts, faces = load_ply(mesh_path)
        with open(cam_path) as f:
            cam_param = json.load(f)
        smplx_depth = render_smplx_depth(
            on_dev(verts), faces, np.asarray(cam_param["focal"], np.float32),
            np.asarray(cam_param["princpt"], np.float32), (h, w),
        )
        # relative -> low = close (reference's 255 - gray flip), then align
        rel_low = hi - rel
        aligned = align_depth_to_smplx(on_dev(rel_low), smplx_depth)
        mask = cv2.imread(mask_path)[:, :, 0].astype(np.float32) / 255.0
        accum.add(aligned, on_dev(img[:, :, ::-1]).float() / 255.0, on_dev(mask))
        n_accum += 1

    if video is not None:
        video.release()
    if n_accum and cam_param is not None:
        # back-project with the last frame's intrinsics (the reference uses
        # the loop's final cam_param too, run_depth_anything.py:109-121;
        # Custom-layout subjects share one virtual camera anyway)
        cloud = accum.point_cloud(
            np.asarray(cam_param["focal"], np.float32),
            np.asarray(cam_param["princpt"], np.float32),
        )
        save_bkg_point_cloud(
            osp.join(subject_root, "bkg_point_cloud.txt"), cloud
        )
        print(f"[run_depth_anything] bkg_point_cloud.txt: "
              f"{cloud.shape[0]} points from {n_accum} frames")
    else:
        print("[run_depth_anything] no fitted meshes/masks yet — wrote "
              "depth maps only (re-run after the fit stage for the cloud)")
    return n_accum


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI. Returns the number of frames accumulated (0 when
    depth_anything_v2 is not importable)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--encoder", default="vitl",
                    choices=["vits", "vitb", "vitl"])
    ap.add_argument("--checkpoint",
                    default="checkpoints/depth_anything_v2_vitl.pth")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--no_video", action="store_true")
    args = ap.parse_args(argv)

    try:
        predict = load_depth_model(args.checkpoint, args.encoder, args.device)
    except ImportError:
        print("[run_depth_anything] depth_anything_v2 not importable; "
              "skipping (install it + download the checkpoint to enable)")
        return 0
    return run_subject(args.subject_root, predict, not args.no_video, args.device)


if __name__ == "__main__":
    main()
