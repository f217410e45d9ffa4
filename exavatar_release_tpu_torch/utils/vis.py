"""Video export of rendered frames (counterpart of ``write_video`` in
exavatar_release_tpu/utils/vis.py; its mesh overlay is not ported)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def write_video(path: str, frames_hwc: Sequence[np.ndarray], fps: int = 30) -> None:
    """Write [0,1] HWC RGB frames to an mp4 with cv2, imported here: where cv2
    is not installed this raises ImportError."""
    import cv2

    assert len(frames_hwc) > 0
    H, W = frames_hwc[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for fr in frames_hwc:
        vw.write((np.clip(fr, 0, 1)[..., ::-1] * 255).astype(np.uint8))
    vw.release()
