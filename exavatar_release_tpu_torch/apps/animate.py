"""Animation CLI (counterpart of exavatar_release_tpu/apps/animate.py;
reference avatar/main/animate.py, animate_view_rot.py, get_neutral_pose.py):
drive a trained avatar with a motion directory, optionally from a camera
orbiting the subject, or render the 大-pose turntable.

    python -m exavatar_release_tpu_torch.apps.animate --subject_root ... --ckpt ...
        --motion_dir <dir of smplx_params jsons> [--view_rot]
    python -m exavatar_release_tpu_torch.apps.animate --subject_root ... --ckpt ...
        --neutral_pose [--num_views 50]  # turntable + point cloud export

Frames are written as PNG (utils/png.py); ``--video`` also writes an mp4
through cv2, which must then be installed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..avatar.config import AvatarConfig
from ..avatar.human import HumanBuffers, HumanGaussians, human_forward
from ..avatar.param_dict import PosedSMPLXParams
from ..core.camera import Camera
from ..models.smplx.prior import SMPLXIDInfo, SMPLXPrior
from ..ops.rasterizer.api import RasterizeSettings, rasterize
from ..utils.profiling import span


@torch.no_grad()
def render_motion(
    human: HumanGaussians,
    buffers: HumanBuffers,
    prior: SMPLXPrior,
    id_info: SMPLXIDInfo,
    poses: Sequence[PosedSMPLXParams],
    cams: Sequence[Camera],
    cfg: AvatarConfig,
    settings: RasterizeSettings,
    img_size,
) -> List[Dict[str, torch.Tensor]]:
    """Render one frame per (pose, camera): ``human_forward``, then one
    ``rasterize`` of the refined Gaussians over a white background. Poses
    are in camera coordinates, as the fitted motion files store them.
    Returns each frame's ``rasterize`` output (``img`` is (H, W, 3))."""
    H, W = img_size
    bg = torch.ones(3, device=human.triplane.device)
    frames = []
    for pose, cam in zip(poses, cams, strict=True):
        with span("animate.frame"):
            hout = human_forward(human, buffers, prior, pose, id_info, cam.R, cam.t, cfg)
            a = hout.assets_refined
            frames.append(rasterize(
                a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam, (H, W),
                bg, settings,
            ))
    return frames


def _orbit_camera(center: np.ndarray, radius: float, angle: float, focal, princpt,
                  device) -> Camera:
    """Camera orbiting around a world center (reference
    animate_view_rot.py:59-119 / get_neutral_pose.py:76-87)."""
    from ..core.camera import look_at

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    eye = center + radius * np.asarray([math.sin(angle), 0.0, math.cos(angle)], np.float32)
    R, tr = look_at(t(eye), t(center), t([0.0, -1.0, 0.0]))
    return Camera(R, tr, t(focal), t(princpt))


def _motion_pose(path: str, E: int, device) -> PosedSMPLXParams:
    with open(path) as f:
        p = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
    t = lambda x, shape: torch.from_numpy(np.ascontiguousarray(x).reshape(shape)).to(device)
    return PosedSMPLXParams(
        root_pose=t(p["root_pose"], 3), body_pose=t(p["body_pose"], (21, 3)),
        jaw_pose=t(p["jaw_pose"], 3), leye_pose=t(p.get("leye_pose", np.zeros(3)), 3),
        reye_pose=t(p.get("reye_pose", np.zeros(3)), 3),
        lhand_pose=t(p["lhand_pose"], (15, 3)), rhand_pose=t(p["rhand_pose"], (15, 3)),
        expr=t(p["expr"].reshape(-1)[:E], -1), trans=t(p["trans"], 3))


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """The animation CLI; returns the paths of the frames it wrote."""
    from ..avatar.human import neutral_pose_human
    from ..utils.png import save_image
    from .common import add_common_args, settings_from_args
    from .test import load_for_render

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--motion_dir", default=None)
    ap.add_argument("--view_rot", action="store_true")
    ap.add_argument("--neutral_pose", action="store_true")
    ap.add_argument("--num_views", type=int, default=50)
    ap.add_argument("--img_size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--out_dir", default="output/animate")
    ap.add_argument("--video", action="store_true",
                    help="also write an mp4 of the rendered frames (needs cv2)")
    ap.add_argument("--fps", type=int, default=30)
    args = ap.parse_args(argv)

    cfg, subject, bundle, state, _ = load_for_render(args, "train")
    dev = torch.device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    H, W = args.img_size
    settings = settings_from_args(args)
    prior, human = bundle.prior, state.trainables.human
    E = prior.assets.num_expr
    written, frames_out = [], []

    def emit(name, out):
        img = out["img"].cpu().numpy()
        written.append(osp.join(args.out_dir, name))
        save_image(written[-1], img)
        frames_out.append(img)

    if args.neutral_pose:
        # 大-pose turntable (reference get_neutral_pose.py:53-93)
        neutral_pose_human(prior, human.shape_param.detach(), bundle.id_info, jaw_zero_pose=True)
        z3 = torch.zeros(3, device=dev)
        zero = PosedSMPLXParams(
            root_pose=z3, body_pose=prior.neutral_body_pose, jaw_pose=z3, leye_pose=z3,
            reye_pose=z3, lhand_pose=torch.zeros(15, 3, device=dev),
            rhand_pose=torch.zeros(15, 3, device=dev), expr=torch.zeros(E, device=dev),
            trans=z3)
        with torch.no_grad():
            hout = human_forward(human, bundle.buffers, prior, zero, bundle.id_info,
                                 torch.eye(3, device=dev), z3, cfg, is_world_coord=True)
            mean, rgb = hout.assets.mean_3d.cpu().numpy(), hout.assets.rgb.cpu().numpy()
            np.savetxt(osp.join(args.out_dir, "neutral_pose_points.xyz"),
                       np.concatenate([mean, rgb], 1))
            a = hout.assets_refined
            for v in range(args.num_views):
                cam = _orbit_camera(mean.mean(0), 2.5, 2 * math.pi * v / args.num_views,
                                    [max(H, W) * 1.2] * 2, [W / 2, H / 2], dev)
                emit(f"neutral_{v:04d}.png", rasterize(
                    a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam, (H, W),
                    torch.ones(3, device=dev), settings))
        video = "turntable.mp4"
    else:
        if not args.motion_dir:
            raise SystemExit("--motion_dir required unless --neutral_pose")
        motion_files = sorted(glob(osp.join(args.motion_dir, "*.json")))
        cp = subject.cam_params[sorted(subject.cam_params)[0]]
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        poses = [_motion_pose(mf, E, dev) for mf in motion_files]
        if args.view_rot:
            cams = [_orbit_camera(np.asarray([0.0, 0.0, 2.5], np.float32), 2.5,
                                  2 * math.pi * vi / max(len(motion_files), 1), cp["focal"],
                                  [W / 2, H / 2], dev) for vi in range(len(poses))]
        else:
            cams = [Camera(t(cp["R"]), t(cp["t"]), t(cp["focal"]), t(cp["princpt"]))] * len(poses)
        for vi, pose in enumerate(poses):
            # one frame at a time: render_motion holds nothing across frames
            emit(f"motion_{vi:05d}.png", render_motion(
                human, bundle.buffers, prior, bundle.id_info, [pose], [cams[vi]], cfg, settings,
                (H, W))[0])
            print(f"motion frame {vi} done")
        video = "motion.mp4"
    if args.video and frames_out:
        from ..utils.vis import write_video

        write_video(osp.join(args.out_dir, video), frames_out, args.fps)
        print(f"wrote {video}")
    print(f"{len(written)} frames written to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
