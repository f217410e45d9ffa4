"""A small PNG writer: numpy and the standard library's zlib, 8-bit gray or
RGB, one IDAT chunk, every scanline with filter 0 (none). It stands in for
``cv2.imwrite`` where the apps write images, so that they run where cv2 is
not installed; any PNG reader (cv2, the native decoder) reads the files."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write ``img``, (H, W) gray or (H, W, 3) RGB uint8, to ``path``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) images, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter byte 0
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_MAGIC + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def save_image(path: str, img_hwc) -> None:
    """An (H, W, 3) RGB image in [0, 1] (numpy or a tensor on any device),
    clipped and quantized as ``cv2.imwrite`` of the JAX apps does it."""
    if hasattr(img_hwc, "detach"):
        img_hwc = img_hwc.detach().cpu().numpy()
    arr = np.clip(np.asarray(img_hwc), 0, 1)
    write_png(path, (arr * 255).astype(np.uint8))
