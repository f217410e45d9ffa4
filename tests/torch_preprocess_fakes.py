"""Injected backends for the preprocessing drivers (apps/run_mmpose.py,
apps/run_sam.py, apps/run_depth_anything.py), the same objects for the JAX
package's drivers and the port's, and a subject for them.

Each fake answers from the image it is given, so that the two drivers, which
visit the frames in the same order but decode them separately, get the same
answers. The mmpose fake returns two instances with equal mean scores (the
driver's strict ``<`` keeps the first) and a weaker third.
"""
import json
import os
import os.path as osp
import shutil

import numpy as np

NUM_KPT = 133


def fake_wholebody(seed=0):
    """An ``InferFn``: three instances, drawn from ``seed`` and the image's
    mean."""
    base = np.random.default_rng(seed)
    xy0 = base.uniform(4, 28, (NUM_KPT, 2)).astype(np.float32)
    sc0 = base.uniform(0.3, 1.0, NUM_KPT).astype(np.float32)

    def infer(img_rgb):
        shift = np.float32(img_rgb.mean() / 64.0)
        tied = sc0[::-1].copy()  # the same mean score as ``sc0``
        return [(xy0 + shift, sc0), (xy0[::-1] + shift, tied),
                (xy0 * 0.5, sc0 * np.float32(0.5))]

    return infer


class FakeSamPredictor:
    """SamPredictor's interface: the mask is the prompt box shrunk by the
    image's mean over 64 pixels (tests/test_apps_e2e.py's, image-driven),
    one score, constant logits."""

    def __init__(self):
        self.calls = []

    def set_image(self, img):
        self.img = img

    def predict(self, point_coords, point_labels, box, multimask_output, mask_input=None):
        self.calls.append(mask_input is None)
        h, w = self.img.shape[:2]
        yy, xx = np.mgrid[:h, :w]
        b = np.asarray(box, np.float32)[0]
        d = float(self.img.mean()) / 64.0
        m = (xx >= b[0] + d) & (xx < b[2] - d) & (yy >= b[1] + d) & (yy < b[3] - d)
        return m[None], np.array([0.9]), np.full((1, h, w), 3.0, np.float32)


def fake_depth(img_rgb):
    """Relative inverse depth (LARGER = closer): a vertical ramp plus a
    fraction of the image's green channel."""
    h, w = img_rgb.shape[:2]
    ramp = np.linspace(2.0, 1.0, h, dtype=np.float32)[:, None]
    return (ramp + img_rgb[:, :, 1].astype(np.float32) / 1024.0).astype(np.float32)


def write_driver_subject(root, posed_meshes, faces, focal=(60.0, 61.0)):
    """Give a ``make_synthetic_subject`` directory what the drivers read:
    ``frames/`` (its ``images/``), ``cam_params/`` and
    ``smplx_optimized/meshes_smoothed/<i>_smplx.ply`` from ``posed_meshes``
    (camera space)."""
    from exavatar_release_tpu_torch.utils.mesh_io import save_ply

    shutil.copytree(osp.join(root, "images"), osp.join(root, "frames"))
    img = osp.join(root, "frames", "0.png")
    import cv2

    h, w = cv2.imread(img).shape[:2]
    os.makedirs(osp.join(root, "cam_params"), exist_ok=True)
    meshes = osp.join(root, "smplx_optimized", "meshes_smoothed")
    os.makedirs(meshes, exist_ok=True)
    for i, verts in enumerate(posed_meshes):
        with open(osp.join(root, "cam_params", f"{i}.json"), "w") as f:
            json.dump({"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0], "focal": list(focal),
                       "princpt": [w / 2.0, h / 2.0]}, f)
        save_ply(osp.join(meshes, f"{i}_smplx.ply"), verts, faces)
