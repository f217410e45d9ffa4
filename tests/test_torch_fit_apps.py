"""The PyTorch port's fitting CLIs on the CPU, on the synthetic subject of
tests/test_apps_e2e.py (tests/test_data.py, 2 frames of 32 x 40), the
synthetic body at 8 rings x 12 segments and the fitting schedule cut to 6
iterations of 1 epoch, as tests/test_apps_e2e.py:test_fit_unwrap_cycle cuts
it: ``apps.fit.main`` writes ``smplx_optimized/`` in the reference layout,
``apps.unwrap.main --uv_size 32`` the face texture, and the port's train CLI
takes a step on the result. With the check renders on, the meshes, overlays
and the check video are written (or, where cv2 is not installed, the CLI
refuses before fitting). Without ``--device cpu`` and without a card, the
CLIs raise."""
import functools
import importlib.util
import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.apps import common, fit, train, unwrap
from exavatar_release_tpu_torch.data.subject import load_subject, read_rgb
from exavatar_release_tpu_torch.fitting import config as fit_config
from exavatar_release_tpu_torch.utils.mesh_io import load_ply
from test_data import make_synthetic_subject

torch.set_num_threads(2)

RINGS, SEGS = 8, 12
HAS_CV2 = importlib.util.find_spec("cv2") is not None


@pytest.fixture()
def subject(tmp_path, monkeypatch):
    """A subject without ``smplx_optimized/``, the tiny synthetic body and the
    cut schedule."""
    root = str(tmp_path / "subject")
    make_synthetic_subject(root, n_frames=2, H=32, W=40)
    shutil.rmtree(osp.join(root, "smplx_optimized"))
    monkeypatch.setitem(common.SYNTHETIC_BODY, "rings", RINGS)
    monkeypatch.setitem(common.SYNTHETIC_BODY, "segs", SEGS)
    monkeypatch.setattr(fit_config.FittingConfig, "itr_opt_num", lambda self, epoch: 6)
    monkeypatch.setattr(fit_config, "FittingConfig",
                        functools.partial(fit_config.FittingConfig, end_epoch=1))
    return root


def test_fit_unwrap_cycle_and_train_loads_it(subject, tmp_path):
    history = fit.main(["--subject_root", subject, "--device", "cpu", "--no_vis"])
    assert [h["itr"] for h in history] == list(range(6))
    assert all(np.isfinite(h["total"]) and np.isfinite(h["smplx_kpt_proj"]) for h in history)
    out = osp.join(subject, "smplx_optimized")
    for fid in (0, 1):
        with open(osp.join(out, "smplx_params", f"{fid}.json")) as f:
            d = json.load(f)
        assert set(d) == {"root_pose", "body_pose", "jaw_pose", "leye_pose", "reye_pose",
                          "lhand_pose", "rhand_pose", "expr", "trans"}
        assert np.asarray(d["body_pose"]).shape == (21, 3) and len(d["expr"]) == 8
    V = (RINGS - 1) * SEGS + 2
    Vf = (12 - 1) * 16 + 2  # the synthetic FLAME head: the face offset's rows
    for name, shape in (("shape_param.json", (16,)), ("face_offset.json", (Vf, 3)),
                        ("joint_offset.json", (55, 3)), ("locator_offset.json", (55, 3))):
        with open(osp.join(out, name)) as f:
            arr = np.asarray(json.load(f))
        assert np.isfinite(arr).all() and arr.shape == shape, name
    assert not osp.exists(osp.join(out, "meshes"))  # --no_vis

    coverage = unwrap.main(["--subject_root", subject, "--device", "cpu", "--uv_size", "32"])
    tex = read_rgb(osp.join(out, "face_texture.png"))
    mask = read_rgb(osp.join(out, "face_texture_mask.png"))
    assert tex.shape == mask.shape == (3, 32, 32)
    assert (mask == mask[:1]).all() and set(np.unique(mask)) <= {0.0, 1.0}
    assert 0 < coverage == float(mask[0].mean())

    # the avatar side reads the fit: identity tables, parameters, texture
    s = load_subject(subject)
    assert s.face_texture_path is not None and s.shape_param.shape == (16,)
    assert sorted(s.smplx_params) == [0, 1] and s.face_offset.shape == (Vf, 3)
    run = train.main(["--subject_root", subject, "--device", "cpu", "--scene_capacity", "512",
                      "--triplane_ch", "8", "--triplane_res", "16", "--raster_backend", "ref",
                      "--allow_random_lpips", "--epochs", "1", "--repeat", "1", "--max_itrs",
                      "1", "--out_dir", str(tmp_path / "train")])
    assert len(run.history) == 1 and np.isfinite(run.history[0]["total"])


def test_fit_check_renders(subject):
    args = ["--subject_root", subject, "--device", "cpu"]
    if not HAS_CV2:
        with pytest.raises(SystemExit, match="cv2"):
            fit.main(args)
        assert not osp.exists(osp.join(subject, "smplx_optimized"))
        return
    os.makedirs(osp.join(subject, "cam_params"))
    for fid in (0, 1):
        with open(osp.join(subject, "cam_params", f"{fid}.json"), "w") as f:
            json.dump({"focal": [60.0, 61.0], "princpt": [20.0, 16.0]}, f)
    fit.main(args)
    out = osp.join(subject, "smplx_optimized")
    V = (RINGS - 1) * SEGS + 2
    for name, nv in (("meshes/0_smplx.ply", V), ("meshes/1_smplx.ply", V),
                     ("meshes/0_flame.ply", None), ("smplx_wo_pose_wo_expr.ply", V),
                     ("smplx_wo_pose_wo_expr_wo_fo.ply", V), ("flame_wo_pose_wo_expr.ply", None)):
        verts, faces = load_ply(osp.join(out, name))
        assert np.isfinite(verts).all() and faces is not None and faces.max() < len(verts), name
        assert nv is None or len(verts) == nv, name
    import cv2

    for fid in (0, 1):
        img = cv2.imread(osp.join(out, "renders", f"{fid}_smplx.jpg"))
        assert img.shape == (32, 40, 3)
    cap = cv2.VideoCapture(osp.join(subject, "smplx_optimized.mp4"))
    assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 80  # frame | overlay
    cap.release()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is")
def test_clis_need_the_card_unless_told_cpu(subject):
    for cli, extra in ((fit, ["--no_vis"]), (unwrap, [])):
        with pytest.raises((RuntimeError, AssertionError), match="CUDA|NVIDIA"):
            cli.main(["--subject_root", subject] + extra)
