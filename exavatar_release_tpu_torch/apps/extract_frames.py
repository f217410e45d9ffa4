"""Extract video frames into the subject layout (counterpart of
exavatar_release_tpu/apps/extract_frames.py; reference
fitting/tools/extract_frames.py:14-27): ``<root>/video.mp4`` ->
``<root>/frames/<idx>.png``, 0-indexed, every frame. Host work, over cv2.

    python -m exavatar_release_tpu_torch.apps.extract_frames --subject_root <dir>
        [--video video.mp4] [--every 1]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence


def extract_frames(subject_root: str, video: str = "video.mp4", every: int = 1) -> int:
    """Decode ``<subject_root>/<video>`` into frames/; returns frame count.
    ``every``: keep every k-th frame (the reference keeps all; phone scans
    at 60 fps often want 2-3)."""
    import cv2

    out_dir = osp.join(subject_root, "frames")
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(osp.join(subject_root, video))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, frame = cap.read()
    idx = written = 0
    while ok:
        if idx % every == 0:
            print(f"{idx}/{total}", end="\r")
            cv2.imwrite(osp.join(out_dir, f"{idx}.png"), frame)
            written += 1
        ok, frame = cap.read()
        idx += 1
    cap.release()
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI. Returns the number of frames written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject_root", required=True)
    ap.add_argument("--video", default="video.mp4")
    ap.add_argument("--every", type=int, default=1)
    args = ap.parse_args(argv)
    n = extract_frames(args.subject_root, args.video, args.every)
    print(f"[extract_frames] wrote {n} frames to {args.subject_root}/frames")
    return n


if __name__ == "__main__":
    main()
