"""Whole-body 2D keypoint estimation driver (counterpart of
exavatar_release_tpu/apps/run_mmpose.py; the reference's mmpose shim,
fitting/tools/code_to_copy/run_mmpose.py:26-52, reimplemented as a
first-class app instead of copy-into-the-mmpose-repo glue that shells out
to ``demo/topdown_demo_with_mmdet.py``).

For every frame under ``frames/``: run a whole-body pose estimator (133
COCO-WholeBody keypoints — body 23, feet 6, face 68, hands 2x21), keep the
detected instance with the highest mean keypoint score (the reference's
selection rule, run_mmpose.py:43-49), and write
``keypoints_whole_body/<idx>.json`` as a (133, 3) [x, y, score] list —
the layout both ``apps/run_sam.py`` (mask prompts) and the fitting stage
(fitting/kpt_convert.py) consume. Optionally writes a side-by-side check
video with the keypoints drawn.

The inference backend is pluggable: by default this imports ``mmpose``'s
``MMPoseInferencer`` only when actually run, so the module stays importable
— and the preprocess orchestrator can skip it cleanly — in environments
without mmpose. Any callable mapping an RGB image to a list of
(keypoints (K, 2), scores (K,)) instances can be injected for testing or
to call a remote endpoint.

Host work over cv2 around the network, which runs on ``--device`` (``cuda``
by default).

    python -m exavatar_release_tpu_torch.apps.run_mmpose --subject_root <dir>
        [--model wholebody] [--device cuda|cpu] [--no_video]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from glob import glob
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# 133 = 23 body + 6 feet + 68 face + 21 left hand + 21 right hand
NUM_WHOLEBODY_KPT = 133

InferFn = Callable[[np.ndarray], List[Tuple[np.ndarray, np.ndarray]]]


def best_instance(
    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> np.ndarray:
    """Pick the instance with the highest MEAN keypoint score and return it
    as (K, 3) [x, y, score] (reference run_mmpose.py:43-49: multi-person
    frames keep only the most confident detection — the monocular-subject
    assumption of the whole pipeline)."""
    kpt_save = None
    for xy, score in instances:
        xy = np.asarray(xy, np.float32).reshape(-1, 2)
        score = np.asarray(score, np.float32).reshape(-1, 1)
        kpt = np.concatenate([xy, score], axis=1)
        if kpt_save is None or kpt_save[:, 2].mean() < kpt[:, 2].mean():
            kpt_save = kpt
    if kpt_save is None:
        return np.zeros((NUM_WHOLEBODY_KPT, 3), np.float32)
    return kpt_save


def load_mmpose_inferencer(model: str = "wholebody", device: str = "cuda") -> InferFn:
    """Build a real mmpose inferencer; raises ImportError when ``mmpose``
    is absent (callers surface that as a skip, like the preprocess
    orchestrator's other external detectors). ``model`` is an MMPose alias
    or config name — the default 'wholebody' alias resolves to an RTMPose
    COCO-WholeBody model equivalent to the reference's
    rtmpose-l_..._coco-ubody-wholebody-384x288 + DWPose checkpoint."""
    from mmpose.apis import MMPoseInferencer

    inferencer = MMPoseInferencer(pose2d=model, device=device)

    def infer(img_rgb: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        out = []
        for result in inferencer(img_rgb, show=False, return_vis=False):
            for inst in result["predictions"][0]:
                out.append((
                    np.asarray(inst["keypoints"], np.float32),
                    np.asarray(inst["keypoint_scores"], np.float32),
                ))
        return out

    return infer


def draw_keypoints(img_bgr: np.ndarray, kpt: np.ndarray,
                   thresh: float = 0.3) -> np.ndarray:
    """Dot overlay for the check video (stands in for the mmpose demo's
    visualization output the reference concatenates)."""
    import cv2

    vis = img_bgr.copy()
    for x, y, s in kpt:
        if s > thresh:
            cv2.circle(vis, (int(x), int(y)), 2, (0, 255, 0), -1)
    return vis


def run_subject(subject_root: str, infer: InferFn,
                write_video: bool = True) -> int:
    """Estimate keypoints for every frame under ``frames/`` into
    ``keypoints_whole_body/`` (reference run_mmpose.py:26-52 + the
    check-video loop at 54-66). Returns the number of frames processed."""
    import cv2

    out_dir = osp.join(subject_root, "keypoints_whole_body")
    os.makedirs(out_dir, exist_ok=True)
    img_paths = glob(osp.join(subject_root, "frames", "*.png"))
    frame_ids = sorted(int(osp.basename(p)[:-4]) for p in img_paths)
    if not frame_ids:
        print(f"[run_mmpose] no frames under {subject_root}/frames")
        return 0

    h, w = cv2.imread(
        osp.join(subject_root, "frames", f"{frame_ids[0]}.png")
    ).shape[:2]
    video = None
    if write_video:
        video = cv2.VideoWriter(
            osp.join(subject_root, "keypoints_whole_body.mp4"),
            cv2.VideoWriter_fourcc(*"mp4v"), 30, (w * 2, h),
        )

    for idx in frame_ids:
        img = cv2.imread(osp.join(subject_root, "frames", f"{idx}.png"))
        instances = infer(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        kpt = best_instance(instances)
        with open(osp.join(out_dir, f"{idx}.json"), "w") as f:
            json.dump(kpt.tolist(), f)
        if video is not None:
            frame = np.concatenate((img, draw_keypoints(img, kpt)), 1)
            frame = cv2.putText(
                frame, str(idx), (int(w * 0.1), int(h * 0.1)),
                cv2.FONT_HERSHEY_PLAIN, 2.0, (0, 0, 255), 3,
            )
            video.write(frame.astype(np.uint8))
    if video is not None:
        video.release()
    return len(frame_ids)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI. Returns the number of frames processed (0 when mmpose is
    not importable)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--model", default="wholebody")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--no_video", action="store_true")
    args = ap.parse_args(argv)

    try:
        infer = load_mmpose_inferencer(args.model, args.device)
    except ImportError:
        print("[run_mmpose] mmpose not importable; skipping "
              "(install mmpose to enable)")
        return 0
    n = run_subject(args.subject_root, infer, not args.no_video)
    print(f"[run_mmpose] wrote {n} keypoint files to "
          f"{args.subject_root}/keypoints_whole_body")
    return n


if __name__ == "__main__":
    main()
