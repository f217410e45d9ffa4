"""Avatar test-render CLI (counterpart of exavatar_release_tpu/apps/test.py;
reference avatar/main/test.py): render every test-split frame and write the
9 composition images as PNG (utils/png.py: no cv2 needed).

    python -m exavatar_release_tpu_torch.apps.test --subject_root <dir> --ckpt <npz>
        [--out_dir output/result] [--device cuda|cpu] ...
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np
import torch

RENDER_KEYS = (
    "scene_img", "human_img", "scene_human_img", "human_img_refined", "scene_human_img_refined",
    "human_face_img", "human_face_img_refined", "scene_human_img_composed",
    "scene_human_img_refined_composed",
)


def load_for_render(args, split: str, lpips_quiet: bool = True):
    """(cfg, subject, bundle, state, frame_row_of) of a CLI's subject and
    ``--ckpt``, on ``--device``: the checkpoint's trainables and scene replace
    the freshly built ones."""
    from ..avatar.config import AvatarConfig
    from ..data.subject import load_subject
    from ..train.checkpoint import load_checkpoint
    from .common import build_prior_for, face_mesh_for, subject_bundle

    dev = torch.device(args.device)
    cfg = AvatarConfig(scene_capacity=args.scene_capacity, triplane_ch=args.triplane_ch,
                       triplane_res=args.triplane_res)
    subject = load_subject(args.subject_root, split=split, repeat=1)
    prior = build_prior_for(args.human_model_path, "male", dev)
    flame_faces, vertex_uv, face_uv = face_mesh_for(args.human_model_path, prior)
    _, _, bundle, frame_row_of = subject_bundle(subject, prior, cfg, flame_faces, vertex_uv,
                                                face_uv, lpips_quiet=lpips_quiet)
    state, epoch = load_checkpoint(args.ckpt, cfg, dev)
    print(f"loaded epoch {epoch} from {args.ckpt}")
    return cfg, subject, bundle, state, frame_row_of


def render_test_frame(cfg, subject, bundle, state, frame_row_of, frame_idx, settings, device):
    """(frame, forward_frame's test-mode outputs) of one subject frame over a
    white background."""
    from ..avatar.model import forward_frame
    from ..data.subject import load_frame_arrays
    from .common import frame_to_device

    arrs = load_frame_arrays(subject, frame_idx)
    arrs["frame_row"] = frame_row_of[frame_idx]
    frame = frame_to_device(arrs, device)
    b = bundle
    with torch.no_grad():
        out = forward_frame(state.trainables, state.scene_aux, b.buffers, b.prior, b.statics,
                            b.id_info, b.lpips, b.face_texture, b.face_texture_mask,
                            b.init_joint_offset, frame, torch.ones(3, device=device), cfg,
                            is_warmup=False, mode="test", settings=settings)
    return frame, out


def main(argv: Optional[Sequence[str]] = None,
         keep_renders: bool = False) -> Dict[int, Dict[str, np.ndarray]]:
    """The test-render CLI. Returns {frame: {render: (H, W, 3) array}} when
    ``keep_renders``, else {frame: {}}."""
    from ..utils.png import save_image
    from .common import add_common_args, settings_from_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out_dir", default="output/result")
    args = ap.parse_args(argv)

    cfg, subject, bundle, state, frame_row_of = load_for_render(args, "test")
    os.makedirs(args.out_dir, exist_ok=True)
    settings = settings_from_args(args)
    dev = torch.device(args.device)
    kept = {}
    for frame_idx in sorted(set(subject.frame_ids)):
        _, out = render_test_frame(cfg, subject, bundle, state, frame_row_of, frame_idx,
                                   settings, dev)
        kept[frame_idx] = {}
        for name in RENDER_KEYS:
            img = out.renders[name].cpu().numpy()
            save_image(osp.join(args.out_dir, f"{frame_idx}_{name}.png"), img)
            if keep_renders:
                kept[frame_idx][name] = img
        print(f"frame {frame_idx} done")
    return kept


if __name__ == "__main__":
    main()
