"""Subject loading: the reference's on-disk layout -> host structures
(counterpart of exavatar_release_tpu/data/subject.py).

Reads the exact directory format the reference's datasets consume
(reference avatar/data/NeuMan/NeuMan.py:24-162, avatar/data/Custom/
Custom.py): COLMAP sparse/ txts (or virtual cameras json), images/ +
masks/ pngs, keypoints_whole_body/*.json, smplx_optimized/ parameter jsons
and the face texture. Produces numpy/host data; the train loop moves
per-frame payloads to the device.

Images: PNGs go through the port's native decoder (native/loader.py), which
gives the values ``cv2.imread`` gives; cv2 is imported only for files the
decoder does not take (other formats, palette or 16-bit PNGs) and where the
caller asks for it (``use_cv2``, the trainer's ``--loader python``). Where cv2
is not installed, such a read raises ImportError.
"""
from __future__ import annotations

import json
import os.path as osp
from glob import glob
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from .colmap import parse_cameras_txt, parse_images_txt, parse_points3d_txt


class SubjectData(NamedTuple):
    frame_ids: List[int]
    cam_params: Dict[int, Dict[str, np.ndarray]]  # R, t, focal, princpt
    img_paths: Dict[int, str]
    mask_paths: Dict[int, str]
    keypoints: Dict[int, np.ndarray]  # (K, 3) x, y, conf
    smplx_params: Dict[int, Dict[str, np.ndarray]]
    scene_points: np.ndarray  # (N, 6)
    cam_dist_translate: np.ndarray  # (3,)
    cam_dist_radius: float
    shape_param: Optional[np.ndarray]
    face_offset: Optional[np.ndarray]
    joint_offset: Optional[np.ndarray]
    locator_offset: Optional[np.ndarray]
    face_texture_path: Optional[str]
    face_texture_mask_path: Optional[str]


def bbox_from_keypoints(kpt: np.ndarray, valid: np.ndarray,
                        extend_ratio: float = 1.2) -> np.ndarray:
    """[xmin, ymin, w, h] of valid keypoints, extended (reference
    preprocessing.get_bbox)."""
    x = kpt[valid > 0, 0]
    y = kpt[valid > 0, 1]
    if x.size == 0:
        return np.zeros(4, np.float32)
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    cx, w = (xmin + xmax) / 2.0, xmax - xmin
    cy, h = (ymin + ymax) / 2.0, ymax - ymin
    return np.array(
        [cx - 0.5 * w * extend_ratio, cy - 0.5 * h * extend_ratio,
         w * extend_ratio, h * extend_ratio], np.float32,
    )


def camera_distribution(cam_params: Dict[int, Dict[str, np.ndarray]]):
    """Scene camera centroid + 1.1x max spread radius (reference
    NeuMan.get_cam_dist, NeuMan.py:148-162)."""
    pos = np.stack(
        [c["R"].T @ (-c["t"]) for c in cam_params.values()]
    )
    mean = pos.mean(0)
    radius = float(np.sqrt(((pos - mean[None]) ** 2).sum(1)).max()) * 1.1
    return (-mean).astype(np.float32), radius


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_subject(
    root_path: str,
    split: str = "train",
    repeat: int = 1,
    z_quantile: float = 0.95,
) -> SubjectData:
    """Load a reference-format subject directory.

    ``repeat`` replicates the frame list per epoch (reference: x100 NeuMan,
    x15 Custom; NeuMan.py:107, Custom.py:135).
    """
    split_file = osp.join(
        root_path, "test_split.txt" if split == "test" else "train_split.txt"
    )
    if osp.exists(split_file):
        with open(split_file) as f:
            frame_ids = [int(x.strip().split(".")[0]) for x in f if x.strip()]
    else:
        frame_ids = sorted(
            int(osp.basename(p).split(".")[0])
            for p in glob(osp.join(root_path, "images", "*.png"))
        )

    # cameras: COLMAP sparse or per-frame cam_params jsons (Custom layout)
    cam_params: Dict[int, Dict[str, np.ndarray]] = {}
    sparse = osp.join(root_path, "sparse")
    if osp.exists(osp.join(sparse, "cameras.txt")):
        focal, princpt = parse_cameras_txt(osp.join(sparse, "cameras.txt"))
        extr = parse_images_txt(osp.join(sparse, "images.txt"))
        for fid, e in extr.items():
            cam_params[fid] = {
                "R": e["R"], "t": e["t"], "focal": focal, "princpt": princpt
            }
    else:
        for p in glob(osp.join(root_path, "cam_params", "*.json")):
            fid = int(osp.basename(p).split(".")[0])
            d = _load_json(p)
            cam_params[fid] = {
                "R": np.asarray(d.get("R", np.eye(3).tolist()), np.float32),
                "t": np.asarray(d.get("t", [0, 0, 0]), np.float32),
                "focal": np.asarray(d["focal"], np.float32),
                "princpt": np.asarray(d["princpt"], np.float32),
            }

    img_paths = {
        int(osp.basename(p).split(".")[0]): p
        for p in glob(osp.join(root_path, "images", "*.png"))
    }
    mask_paths = {
        int(osp.basename(p).split(".")[0]): p
        for p in glob(osp.join(root_path, "masks", "*.png"))
    }
    keypoints = {
        int(osp.basename(p).split(".")[0]): np.asarray(_load_json(p), np.float32)
        for p in glob(osp.join(root_path, "keypoints_whole_body", "*.json"))
    }
    smplx_params = {}
    for p in glob(osp.join(root_path, "smplx_optimized", "smplx_params", "*.json")):
        fid = int(osp.basename(p).split(".")[0])
        smplx_params[fid] = {
            k: np.asarray(v, np.float32) for k, v in _load_json(p).items()
        }

    pts_path = osp.join(sparse, "points3D.txt")
    if osp.exists(pts_path):
        scene_points = parse_points3d_txt(pts_path, z_quantile)
    else:
        bg = osp.join(root_path, "bkg_point_cloud.txt")
        scene_points = (
            np.loadtxt(bg, dtype=np.float32).reshape(-1, 6)
            if osp.exists(bg) else np.zeros((0, 6), np.float32)
        )

    if cam_params:
        translate, radius = camera_distribution(cam_params)
    else:
        translate, radius = np.zeros(3, np.float32), 1.0

    def opt(name):
        p = osp.join(root_path, "smplx_optimized", name)
        return np.asarray(_load_json(p), np.float32) if osp.exists(p) else None

    tex = osp.join(root_path, "smplx_optimized", "face_texture.png")
    texm = osp.join(root_path, "smplx_optimized", "face_texture_mask.png")

    return SubjectData(
        frame_ids=frame_ids * repeat,
        cam_params=cam_params,
        img_paths=img_paths,
        mask_paths=mask_paths,
        keypoints=keypoints,
        smplx_params=smplx_params,
        scene_points=scene_points,
        cam_dist_translate=translate,
        cam_dist_radius=radius,
        shape_param=opt("shape_param.json"),
        face_offset=opt("face_offset.json"),
        joint_offset=opt("joint_offset.json"),
        locator_offset=opt("locator_offset.json"),
        face_texture_path=tex if osp.exists(tex) else None,
        face_texture_mask_path=texm if osp.exists(texm) else None,
    )


def _as_rgb(chw: np.ndarray) -> np.ndarray:
    """(3, H, W) RGB of a decoded PNG: gray channels repeated, alpha dropped,
    as ``cv2.imread`` in color mode gives them."""
    return chw[:3] if chw.shape[0] >= 3 else np.repeat(chw[:1], 3, axis=0)


def read_rgb(path: str, use_cv2: bool = False) -> np.ndarray:
    """(3, H, W) float32 RGB in [0, 1]: the values of
    ``cv2.imread(path)[:, :, ::-1].astype(np.float32).transpose(2, 0, 1) / 255``.
    PNGs through the native decoder unless ``use_cv2``."""
    if not use_cv2 and path.lower().endswith(".png"):
        from ..native import decode_png_native

        chw = decode_png_native(path)
        if chw is not None:
            return _as_rgb(chw)
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img[:, :, ::-1].astype(np.float32).transpose(2, 0, 1) / 255.0


def frame_from_images(subject: SubjectData, frame_idx: int, img: np.ndarray,
                      mask_rgb: np.ndarray):
    """A frame's arrays from its decoded image and mask, both (3, H, W) RGB
    in [0, 1]: the mask is its blue channel above 127/255, which is
    ``cv2.imread(mask)[:, :, 0] > 127``."""
    mask = (mask_rgb[2:3] > 0.5).astype(np.float32)
    kpt = subject.keypoints.get(frame_idx)
    if kpt is not None:
        bbox = bbox_from_keypoints(kpt[:, :2], (kpt[:, 2] > 0.5).astype(np.float32))
    else:
        bbox = np.array([0, 0, img.shape[2], img.shape[1]], np.float32)
    return {
        "img": img,
        "mask": mask,
        "bbox": bbox,
        "cam_param": subject.cam_params[frame_idx],
        "frame_idx": frame_idx,
    }


def load_frame_arrays(subject: SubjectData, frame_idx: int, use_cv2: bool = False):
    """Decode one frame's image/mask + bbox (reference NeuMan.__getitem__,
    NeuMan.py:129-146). Returns dict of numpy arrays (CHW float in [0,1])."""
    return frame_from_images(subject, frame_idx,
                             read_rgb(subject.img_paths[frame_idx], use_cv2),
                             read_rgb(subject.mask_paths[frame_idx], use_cv2))


class FramePrefetcher:
    """Decode-ahead frame pipeline over the native C++ loader.

    The reference hides image decode behind torch DataLoader workers
    (avatar/main/train.py:34 DataLoader(..., num_workers=...)); here a
    zlib + thread-pool C++ decoder (native/dataloader.cpp) keeps
    ``lookahead`` frames in flight while the step runs on the device, and
    frames are handed back in the submitted epoch order. A file the decoder
    does not take goes through ``load_frame_arrays`` (and so cv2) for that
    frame.
    """

    def __init__(self, subject: SubjectData, order, lookahead: int = 4):
        from ..native import NativeLoader

        self.subject = subject
        self.order = [int(k) for k in order]
        self.lookahead = lookahead
        self.loader = NativeLoader(num_threads=8, queue_cap=2 * lookahead + 4)
        self._buf = {}
        self._submitted = 0
        self._pos = 0

    def close(self):
        self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _submit_ahead(self):
        while (self._submitted < len(self.order)
               and self._submitted < self._pos + self.lookahead):
            i = self._submitted
            fidx = self.subject.frame_ids[self.order[i]]
            self.loader.submit(2 * i, self.subject.img_paths[fidx])
            self.loader.submit(2 * i + 1, self.subject.mask_paths[fidx])
            self._submitted += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.order):
            self.close()
            raise StopIteration
        self._submit_ahead()
        i = self._pos
        want = (2 * i, 2 * i + 1)
        while not all(w in self._buf for w in want):
            rid, arr = self.loader.wait()
            if rid < 0:
                break  # queue drained or a file not taken; missing ids fall back below
            self._buf[rid] = arr
        img = self._buf.pop(want[0], None)
        mask = self._buf.pop(want[1], None)
        self._pos += 1

        fidx = self.subject.frame_ids[self.order[i]]
        if img is None or mask is None:
            return load_frame_arrays(self.subject, fidx)
        return frame_from_images(self.subject, fidx, _as_rgb(img), _as_rgb(mask))
