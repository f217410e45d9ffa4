"""Face-texture unwrap CLI (counterpart of exavatar_release_tpu/apps/unwrap.py;
reference fitting/main/unwrap.py).

Poses the fitted SMPL-X per frame, takes the FLAME-correspondence face
region, and unwraps video pixels into the 512x512 UV atlas averaged over
frames; writes smplx_optimized/face_texture.png + face_texture_mask.png in
the reference layout the avatar stage consumes (utils/png.py: the pixels
``cv2.imwrite`` of the JAX CLI writes, without cv2).

    python -m exavatar_release_tpu_torch.apps.unwrap --subject_root <dir>
        [--human_model_path <dir>] [--uv_size 512] [--max_frames 64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> float:
    """The unwrap CLI. Returns the texture mask's coverage (0..1)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--human_model_path", default=None)
    ap.add_argument("--uv_size", type=int, default=512)
    ap.add_argument("--max_frames", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..data.subject import load_subject, read_rgb
    from ..fitting.unwrap import build_uv_maps, unwrap_sequence
    from ..models.smplx import SMPLXParams, smplx_forward
    from ..utils.png import write_png
    from .common import build_prior_for, face_mesh_for

    dev = torch.device(args.device)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    subject = load_subject(args.subject_root, split="train", repeat=1)
    prior = build_prior_for(args.human_model_path, "male", dev)
    a = prior.assets

    # UV tables over the face mesh (FLAME UV for real assets)
    face_faces, vertex_uv, face_uv = face_mesh_for(args.human_model_path, prior)
    uv_maps = build_uv_maps(t(vertex_uv), torch.from_numpy(np.asarray(face_uv)).to(dev),
                            (args.uv_size, args.uv_size))

    fv = prior.face_vertex_idx.long()
    shape = np.zeros(a.num_shape, np.float32)
    if subject.shape_param is not None:
        sp_ = np.asarray(subject.shape_param, np.float32).reshape(-1)[: a.num_shape]
        shape[: sp_.size] = sp_

    frame_ids = sorted(set(subject.frame_ids))[: args.max_frames]
    meshes, imgs, focals, princpts = [], [], [], []
    with torch.no_grad():
        for fid in frame_ids:
            sp = subject.smplx_params.get(fid)
            if sp is None or fid not in subject.img_paths:
                continue
            p = SMPLXParams(
                betas=t(shape),
                expr=t(np.asarray(sp["expr"], np.float32).reshape(-1)[: a.num_expr]),
                root_pose=t(sp["root_pose"]).reshape(3),
                body_pose=t(sp["body_pose"]).reshape(21, 3),
                jaw_pose=t(sp["jaw_pose"]).reshape(3),
                leye_pose=t(sp.get("leye_pose", np.zeros(3))).reshape(3),
                reye_pose=t(sp.get("reye_pose", np.zeros(3))).reshape(3),
                lhand_pose=t(sp["lhand_pose"]).reshape(15, 3),
                rhand_pose=t(sp["rhand_pose"]).reshape(15, 3),
                trans=t(sp["trans"]).reshape(3),
            )
            meshes.append(smplx_forward(a, p, with_landmarks=False).vertices[fv])
            imgs.append(t(read_rgb(subject.img_paths[fid])))
            cp = subject.cam_params[fid]
            focals.append(t(cp["focal"]))
            princpts.append(t(cp["princpt"]))
    assert meshes, "no frames with fitted params + images"

    tex, mask = unwrap_sequence(
        uv_maps, torch.stack(meshes), torch.from_numpy(np.asarray(face_faces, np.int64)).to(dev),
        torch.stack(imgs), torch.stack(focals), torch.stack(princpts))
    out_dir = osp.join(args.subject_root, "smplx_optimized")
    os.makedirs(out_dir, exist_ok=True)
    tex_u8 = (np.clip(tex.cpu().numpy().transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    mask_u8 = (mask.cpu().numpy()[0] * 255).astype(np.uint8)
    write_png(osp.join(out_dir, "face_texture.png"), tex_u8)
    write_png(osp.join(out_dir, "face_texture_mask.png"), np.repeat(mask_u8[:, :, None], 3, axis=2))
    coverage = float((mask_u8 > 0).mean())
    print(f"unwrapped {len(meshes)} frames -> {out_dir}/face_texture.png "
          f"(coverage {coverage:.1%})")
    return coverage


if __name__ == "__main__":
    main()
