"""The PyTorch port's preprocessing apps against the JAX package's on the
CPU, on the synthetic subject of tests/test_data.py (2 frames of 32 x 40),
the 8 x 12 synthetic body posed as the subject's fitted parameters say, and
the injected backends of tests/torch_preprocess_fakes.py:

* the three detector drivers, the JAX package's and the port's, each on its
  own copy of the subject: the keypoint JSONs and the gray depth PNGs are
  equal, the mask PNGs equal, ``bkg_point_cloud.txt`` within 1e-6 + 1e-6
  relative (tests/test_torch_depth_cloud.py's tolerance);
* the fit CLI maps run_mmpose's COCO-WholeBody files to its SMPL-X
  convention (the JAX package's CLI takes them as they are);
* ``extract_frames`` writes the frames JAX's does; ``prepare_fit_pose_to_test``
  re-stamps a snapshot of the port's ``train/checkpoint.py`` as epoch -1,
  leaf for leaf, as JAX's does;
* ``preprocess.main`` with ``--device cpu --skip_fit --smooth_length 3`` in
  this process, with the depth loader injected and the unwrap's atlas cut to
  32 x 32: the smoothed parameters are JAX's ``smooth_sequence`` of the same
  files within 1e-6, and the smoothed meshes, the face texture, the check
  video and the cloud are written. Without ``--device cpu`` and without a
  card it raises before any step.
"""
import json
import os
import os.path as osp
import shutil
from glob import glob

import cv2
import numpy as np
import pytest
import torch

from exavatar_release_tpu.apps import extract_frames as j_extract
from exavatar_release_tpu.apps import prepare_fit_pose_to_test as j_prepare
from exavatar_release_tpu.apps import run_depth_anything as j_depth
from exavatar_release_tpu.apps import run_mmpose as j_mmpose
from exavatar_release_tpu.apps import run_sam as j_sam
from exavatar_release_tpu.data import depth_cloud as j_depth_cloud
from exavatar_release_tpu.fitting.smooth import smooth_sequence as j_smooth_sequence
from exavatar_release_tpu_torch.apps import common, extract_frames, prepare_fit_pose_to_test, \
    preprocess, run_depth_anything, run_mmpose, run_sam, unwrap
from exavatar_release_tpu_torch.models.smplx import SMPLXParams, smplx_forward, \
    synthetic_smplx_assets
from test_data import make_synthetic_subject
from torch_frame_fixture import fast_jit
from torch_preprocess_fakes import FakeSamPredictor, fake_depth, fake_wholebody, \
    write_driver_subject

torch.set_num_threads(2)

# the JAX rasterizer as one program: run op by op it costs ~100 compiles
J_RASTER = fast_jit(j_depth_cloud.rasterize_mesh, static_argnums=(4,))

RINGS, SEGS = 8, 12


def _posed_meshes(root):
    """The subject's fitted parameters through the 8 x 12 synthetic body."""
    a = synthetic_smplx_assets(rings=RINGS, segs=SEGS, device="cpu")
    meshes = []
    for p in sorted(glob(osp.join(root, "smplx_optimized", "smplx_params", "*.json"))):
        with open(p) as f:
            d = {k: torch.tensor(v, dtype=torch.float32) for k, v in json.load(f).items()}
        with torch.no_grad():
            meshes.append(smplx_forward(a, SMPLXParams(betas=torch.zeros(a.num_shape), **d),
                                        with_landmarks=False).vertices.numpy())
    return meshes, a.faces.numpy()


@pytest.fixture()
def subject(tmp_path):
    root = str(tmp_path / "subject")
    make_synthetic_subject(root, n_frames=2, H=32, W=40)
    meshes, faces = _posed_meshes(root)
    write_driver_subject(root, meshes, faces)
    return root


def test_detector_drivers_match_jax(subject, tmp_path, monkeypatch):
    monkeypatch.setattr(j_depth_cloud, "rasterize_mesh", J_RASTER)
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(tmp_path / side)
        shutil.copytree(subject, roots[side])
    sams = {"jax": FakeSamPredictor(), "port": FakeSamPredictor()}
    assert j_mmpose.run_subject(roots["jax"], fake_wholebody(), write_video=True) == 2
    assert run_mmpose.run_subject(roots["port"], fake_wholebody(), write_video=True) == 2
    assert j_sam.run_subject(roots["jax"], sams["jax"], write_video=True) == 2
    assert run_sam.run_subject(roots["port"], sams["port"], write_video=True) == 2
    assert sams["port"].calls == sams["jax"].calls == [True, False] * 2  # two passes a frame
    assert j_depth.run_subject(roots["jax"], fake_depth, write_video=True) == 2
    assert run_depth_anything.run_subject(roots["port"], fake_depth, write_video=True,
                                          device="cpu") == 2
    for fid in (0, 1):
        read = lambda side, *p: osp.join(roots[side], *p)
        with open(read("jax", "keypoints_whole_body", f"{fid}.json")) as f:
            want = json.load(f)
        with open(read("port", "keypoints_whole_body", f"{fid}.json")) as f:
            got = json.load(f)
        assert got == want and np.asarray(got).shape == (133, 3)
        # of the two instances with the best mean score, the first is kept
        first = fake_wholebody()(cv2.cvtColor(cv2.imread(read("port", "frames", f"{fid}.png")),
                                              cv2.COLOR_BGR2RGB))[0]
        np.testing.assert_array_equal(np.asarray(got)[:, :2], first[0])
        for sub in ("masks", "depthmaps"):
            g = cv2.imread(read("port", sub, f"{fid}.png"), cv2.IMREAD_UNCHANGED)
            w = cv2.imread(read("jax", sub, f"{fid}.png"), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(g, w)
        m = cv2.imread(read("port", "masks", f"{fid}.png"), cv2.IMREAD_GRAYSCALE)
        assert set(np.unique(m)) == {0, 255}
    for name in ("keypoints_whole_body.mp4", "masks.mp4", "depthmaps.mp4"):
        assert osp.getsize(osp.join(roots["port"], name)) > 0, name
    want = np.loadtxt(osp.join(roots["jax"], "bkg_point_cloud.txt"), dtype=np.float32)
    got = np.loadtxt(osp.join(roots["port"], "bkg_point_cloud.txt"), dtype=np.float32)
    assert got.shape == want.shape and got.shape[1] == 6 and got.shape[0] > 100
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fit_reads_the_detectors_keypoints(subject):
    """run_mmpose's 133-row files reach the fit in the SMPL-X convention,
    mapped by name; 135-row files as they are."""
    from exavatar_release_tpu.fitting.kpt_convert import coco133_to_smplx135 as j_convert
    from exavatar_release_tpu_torch.apps.fit import load_keypoints

    assert run_mmpose.run_subject(subject, fake_wholebody(), write_video=False) == 2
    with open(osp.join(subject, "keypoints_whole_body", "1.json"), "w") as f:
        json.dump(np.arange(135 * 3, dtype=np.float32).reshape(135, 3).tolist(), f)
    kpts = load_keypoints(subject)
    with open(osp.join(subject, "keypoints_whole_body", "0.json")) as f:
        np.testing.assert_array_equal(kpts[0], j_convert(np.asarray(json.load(f), np.float32)))
    np.testing.assert_array_equal(kpts[1], np.arange(135 * 3).reshape(135, 3))
    assert kpts[0].shape == (135, 3) and kpts[0][:, 2].any()


def test_extract_frames_round_trip(tmp_path):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for root in roots:
        os.makedirs(root)
        vw = cv2.VideoWriter(osp.join(root, "video.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (32, 24))
        for i in range(6):
            vw.write(np.full((24, 32, 3), i * 20, np.uint8))
        vw.release()
    assert j_extract.extract_frames(roots[0], every=2) == 3
    assert extract_frames.main(["--subject_root", roots[1], "--every", "2"]) == 3
    names = sorted(os.listdir(osp.join(roots[1], "frames")))
    assert names == sorted(os.listdir(osp.join(roots[0], "frames"))) == ["0.png", "2.png",
                                                                          "4.png"]
    for n in names:
        got = cv2.imread(osp.join(roots[1], "frames", n))
        np.testing.assert_array_equal(got, cv2.imread(osp.join(roots[0], "frames", n)))
        assert got.shape == (24, 32, 3)


def test_prepare_fit_pose_to_test(tmp_path, monkeypatch):
    from exavatar_release_tpu_torch.avatar import scene as sc
    from exavatar_release_tpu_torch.avatar.config import AvatarConfig
    from exavatar_release_tpu_torch.avatar.human import HumanGaussians
    from exavatar_release_tpu_torch.avatar.model import AvatarTrainables
    from exavatar_release_tpu_torch.avatar.param_dict import init_param_frames
    from exavatar_release_tpu_torch.train import checkpoint as tck
    from exavatar_release_tpu_torch.train.loop import init_train_state
    from exavatar_release_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(0)
    cfg = AvatarConfig(triplane_ch=8, triplane_res=16, scene_capacity=64)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    scene = sc.init_from_point_cloud(t(rng.uniform(-1, 1, (40, 3)) + [0, 0, 4]),
                                     t(rng.uniform(0, 1, (40, 3))), torch.zeros(3), 3.0, 64)
    pose = {"root_pose": np.zeros(3), "body_pose": np.zeros((21, 3)), "jaw_pose": np.zeros(3),
            "leye_pose": np.zeros(3), "reye_pose": np.zeros(3), "lhand_pose": np.zeros((15, 3)),
            "rhand_pose": np.zeros((15, 3)), "expr": rng.normal(size=8), "trans": [0, 0, 2.5]}
    human = HumanGaussians(cfg, 16, 55, torch.Generator().manual_seed(0), device="cpu")
    tr = AvatarTrainables(scene.params, human, init_param_frames([pose, pose], device="cpu"))
    state = init_train_state(tr, scene.aux, make_optimizer(tr, cfg, 3.0, 10))
    src = tck.save_checkpoint(str(tmp_path / "dump"), state, 4)
    out = prepare_fit_pose_to_test.main(["--src", src, "--dst_dir", str(tmp_path / "fit")])
    assert out == str(tmp_path / "fit" / "snapshot_-1.npz")
    monkeypatch.setattr("sys.argv", ["prepare", "--src", src, "--dst_dir",
                                     str(tmp_path / "jax")])
    j_prepare.main()
    with np.load(src) as a, np.load(out) as b, np.load(tmp_path / "jax" / "snapshot_-1.npz") as c:
        assert set(a) == set(b) == set(c) and int(a["epoch"]) == 4
        assert int(b["epoch"]) == int(c["epoch"]) == -1
        for k in a:
            if k != "epoch":
                np.testing.assert_array_equal(b[k], a[k])
                np.testing.assert_array_equal(c[k], a[k])
    assert tck.latest_checkpoint(str(tmp_path / "fit")) == out
    restored, epoch = tck.load_checkpoint(out, cfg, device="cpu")
    assert epoch == -1 and restored.itr == state.itr


def test_preprocess_on_the_cpu(subject, monkeypatch):
    monkeypatch.setitem(common.SYNTHETIC_BODY, "rings", RINGS)
    monkeypatch.setitem(common.SYNTHETIC_BODY, "segs", SEGS)
    unwrap_main = unwrap.main
    monkeypatch.setattr(unwrap, "main", lambda argv: unwrap_main(list(argv) + ["--uv_size", "32"]))

    def absent(*args, **kw):
        raise ImportError("not installed")

    monkeypatch.setattr(run_mmpose, "load_mmpose_inferencer", absent)
    monkeypatch.setattr(run_sam, "load_sam_predictor", absent)
    loaded = []
    monkeypatch.setattr(run_depth_anything, "load_depth_model",
                        lambda ckpt, encoder, device: loaded.append(device) or fake_depth)
    shutil.rmtree(osp.join(subject, "smplx_optimized", "meshes_smoothed"))
    files = sorted(glob(osp.join(subject, "smplx_optimized", "smplx_params", "*.json")))
    seq = []
    for p in files:
        with open(p) as f:
            seq.append({k: np.asarray(v, np.float32) for k, v in json.load(f).items()})

    out = preprocess.main(["--subject_root", subject, "--device", "cpu", "--skip_fit",
                           "--smooth_length", "3"])
    assert loaded == ["cpu"] and out["fit"] is None and 0 < out["coverage"] <= 1
    assert set(out["seconds"]) == {"cameras", "mmpose", "sam", "unwrap", "smooth",
                                   "smooth_video", "depth"}
    for p, want in zip(files, j_smooth_sequence(seq, window_length=3)):
        with open(p) as f:
            got = json.load(f)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k]),
                                       atol=1e-6, err_msg=k)
    opt = osp.join(subject, "smplx_optimized")
    for name in ("meshes_smoothed/0_smplx.ply", "meshes_smoothed/1_smplx.ply",
                 "renders_smoothed/0_smplx.jpg", "face_texture.png", "face_texture_mask.png"):
        assert osp.exists(osp.join(opt, name)), name
    assert osp.getsize(osp.join(subject, "smplx_optimized_smoothed.mp4")) > 0
    cloud = np.loadtxt(osp.join(subject, "bkg_point_cloud.txt"), dtype=np.float32)
    assert cloud.shape[1] == 6 and cloud.shape[0] > 0 and np.isfinite(cloud).all()


def test_preprocess_needs_the_card_unless_told_cpu(subject):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is")
    before = sorted(os.listdir(subject))
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess.main(["--subject_root", subject, "--skip_fit"])
    assert sorted(os.listdir(subject)) == before
