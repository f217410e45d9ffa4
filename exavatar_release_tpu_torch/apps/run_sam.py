"""Keypoint-prompted SAM person segmentation (counterpart of
exavatar_release_tpu/apps/run_sam.py; the reference's detector shim,
fitting/tools/code_to_copy/run_sam.py:40-72, reimplemented as a first-class
app instead of copy-into-the-SAM-repo glue).

For every frame: load the whole-body 2D keypoints, keep those with
confidence > 0.5, build a 1.2x-extended bbox around them, and prompt SAM
twice — first with (points + box), then again feeding back the best mask's
logits as ``mask_input`` (the reference's two-pass refinement). The union
of the returned masks is written to ``masks/<idx>.png`` (0/255), plus an
optional side-by-side check video.

The predictor is pluggable: by default this imports ``segment_anything``
(and torch) only when actually run, so the module stays importable — and the
preprocess orchestrator can skip it cleanly — in environments without SAM.
Any object with SamPredictor's ``set_image`` / ``predict`` interface can be
injected for testing or to call a remote SAM endpoint.

Host work over cv2 around the network, which runs on ``--device`` (``cuda``
by default).

    python -m exavatar_release_tpu_torch.apps.run_sam --subject_root <dir>
        [--checkpoint sam_vit_h_4b8939.pth] [--model_type vit_h] [--device cuda|cpu]
        [--no_video]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from glob import glob
from typing import Optional, Sequence

import numpy as np


def keypoint_bbox(kpt_img: np.ndarray, extend_ratio: float = 1.2) -> np.ndarray:
    """1.2x-extended xyxy bbox around valid keypoints (reference
    run_sam.py:11-25 get_bbox, plus its xywh->xyxy fixup at line 63)."""
    x, y = kpt_img[:, 0], kpt_img[:, 1]
    xmin, xmax = float(x.min()), float(x.max())
    ymin, ymax = float(y.min()), float(y.max())
    xc, w = (xmin + xmax) / 2.0, xmax - xmin
    yc, h = (ymin + ymax) / 2.0, ymax - ymin
    return np.array(
        [xc - 0.5 * w * extend_ratio, yc - 0.5 * h * extend_ratio,
         xc + 0.5 * w * extend_ratio, yc + 0.5 * h * extend_ratio],
        np.float32,
    )


def segment_frame(predictor, img_rgb: np.ndarray, kpt: np.ndarray) -> np.ndarray:
    """One frame's keypoint-prompted two-pass segmentation (reference
    run_sam.py:55-72): points = confident keypoints, labels all-foreground,
    box = extended keypoint bbox; pass 2 feeds back the best logits.

    kpt: (K, 3) [x, y, confidence]. Returns a (H, W) bool mask.
    """
    pts = kpt[kpt[:, 2] > 0.5, :2].astype(np.float32)
    if pts.shape[0] == 0:
        return np.zeros(img_rgb.shape[:2], bool)
    box = keypoint_bbox(pts)[None, :]
    labels = np.ones((pts.shape[0],), np.float32)

    predictor.set_image(img_rgb)
    masks, scores, logits = predictor.predict(
        point_coords=pts, point_labels=labels, box=box,
        multimask_output=False,
    )
    mask_input = logits[int(np.argmax(scores))]
    masks, _, _ = predictor.predict(
        point_coords=pts, point_labels=labels, box=box,
        multimask_output=False, mask_input=mask_input[None],
    )
    return masks.sum(0) > 0


def load_sam_predictor(checkpoint: str, model_type: str = "vit_h", device: str = "cuda"):
    """Build a real SamPredictor; raises ImportError when the
    ``segment_anything`` package is absent (callers should surface that as
    a skip, like the preprocess orchestrator's other external detectors)."""
    from segment_anything import SamPredictor, sam_model_registry

    sam = sam_model_registry[model_type](checkpoint=checkpoint)
    if device != "cpu":
        sam = sam.to(device)
    return SamPredictor(sam)


def run_subject(subject_root: str, predictor, write_video: bool = True) -> int:
    """Segment every frame under ``frames/`` into ``masks/`` (reference
    run_sam.py:50-84). Returns the number of frames processed."""
    import cv2

    out_dir = osp.join(subject_root, "masks")
    os.makedirs(out_dir, exist_ok=True)
    img_paths = glob(osp.join(subject_root, "frames", "*.png"))
    frame_ids = sorted(int(osp.basename(p)[:-4]) for p in img_paths)
    if not frame_ids:
        print(f"[run_sam] no frames under {subject_root}/frames")
        return 0

    h, w = cv2.imread(
        osp.join(subject_root, "frames", f"{frame_ids[0]}.png")
    ).shape[:2]
    video = None
    if write_video:
        video = cv2.VideoWriter(
            osp.join(subject_root, "masks.mp4"),
            cv2.VideoWriter_fourcc(*"mp4v"), 30, (w * 2, h),
        )

    for idx in frame_ids:
        img = cv2.imread(osp.join(subject_root, "frames", f"{idx}.png"))
        with open(osp.join(
            subject_root, "keypoints_whole_body", f"{idx}.json"
        )) as f:
            kpt = np.array(json.load(f), np.float32)
        mask = segment_frame(
            predictor, cv2.cvtColor(img, cv2.COLOR_BGR2RGB), kpt
        )
        cv2.imwrite(
            osp.join(out_dir, f"{idx}.png"), mask.astype(np.uint8) * 255
        )
        if video is not None:
            masked = img.copy()
            masked[~mask] = 0
            frame = np.concatenate((img, masked), 1)
            frame = cv2.putText(
                frame, str(idx), (int(w * 0.1), int(h * 0.1)),
                cv2.FONT_HERSHEY_PLAIN, 2.0, (0, 0, 255), 3,
            )
            video.write(frame.astype(np.uint8))
    if video is not None:
        video.release()
    return len(frame_ids)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI. Returns the number of frames processed (0 when
    segment_anything is not importable)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--checkpoint", default="sam_vit_h_4b8939.pth")
    ap.add_argument("--model_type", default="vit_h")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--no_video", action="store_true")
    args = ap.parse_args(argv)

    try:
        predictor = load_sam_predictor(
            args.checkpoint, args.model_type, args.device
        )
    except ImportError:
        print("[run_sam] segment_anything not importable; skipping "
              "(install it + download the checkpoint to enable)")
        return 0
    n = run_subject(args.subject_root, predictor, not args.no_video)
    print(f"[run_sam] wrote {n} masks to {args.subject_root}/masks")
    return n


if __name__ == "__main__":
    main()
