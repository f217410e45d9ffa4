"""The PyTorch port's data layer against the JAX package's on the CPU, on
synthetic reference-layout subject directories (tests/test_data.py's
``make_synthetic_subject``), exactly:

* ``data.colmap`` parsers and ``load_subject`` (every field, both splits and
  a repeat);
* ``load_frame_arrays`` (the port decodes PNGs natively, the JAX package
  with cv2) and the native ``FramePrefetcher`` in a shuffled order;
* the port's native PNG decoder against ``cv2.imread`` (RGB, RGBA, gray);
* the port's PNG writer, read back by cv2 and by the native decoder.
"""
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from exavatar_release_tpu.data import colmap as j_colmap
from exavatar_release_tpu.data import subject as j_subject
from exavatar_release_tpu_torch.data import colmap as t_colmap
from exavatar_release_tpu_torch.data import subject as t_subject
from exavatar_release_tpu_torch.native import decode_png_native, native_available
from exavatar_release_tpu_torch.utils.png import save_image, write_png
from test_data import make_synthetic_subject

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def subject_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("subject"))
    make_synthetic_subject(root, n_frames=3, H=36, W=52, seed=3)
    return root


def _same(a, b, where=""):
    """Exact equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b and type(a) is type(b), where


def test_native_loader_builds():
    assert native_available()


def test_colmap_parsers(subject_dir):
    sp = osp.join(subject_dir, "sparse")
    _same(t_colmap.parse_cameras_txt(osp.join(sp, "cameras.txt")),
          j_colmap.parse_cameras_txt(osp.join(sp, "cameras.txt")))
    _same(t_colmap.parse_images_txt(osp.join(sp, "images.txt")),
          j_colmap.parse_images_txt(osp.join(sp, "images.txt")))
    for q in (0.95, None):
        _same(t_colmap.parse_points3d_txt(osp.join(sp, "points3D.txt"), q),
              j_colmap.parse_points3d_txt(osp.join(sp, "points3D.txt"), q))


@pytest.mark.parametrize("split,repeat", [("train", 2), ("test", 1)])
def test_load_subject(subject_dir, split, repeat):
    got = t_subject.load_subject(subject_dir, split=split, repeat=repeat)
    want = j_subject.load_subject(subject_dir, split=split, repeat=repeat)
    assert got._fields == want._fields
    for f in want._fields:
        _same(getattr(got, f), getattr(want, f), f)


def test_load_frame_arrays_and_prefetcher(subject_dir):
    sj = j_subject.load_subject(subject_dir, repeat=2)
    st = t_subject.load_subject(subject_dir, repeat=2)
    want = {f: j_subject.load_frame_arrays(sj, f) for f in sorted(set(sj.frame_ids))}
    for f, w in want.items():
        _same(t_subject.load_frame_arrays(st, f), w, f"frame {f}")
        _same(t_subject.load_frame_arrays(st, f, use_cv2=True), w, f"frame {f} (cv2)")
    order = np.random.default_rng(0).permutation(len(st.frame_ids))
    got = list(t_subject.FramePrefetcher(st, order, lookahead=2))
    assert [g["frame_idx"] for g in got] == [st.frame_ids[k] for k in order]
    for g in got:
        _same(g, want[g["frame_idx"]], f"prefetched {g['frame_idx']}")


def test_native_decode_vs_cv2(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (23, 37, 3), np.uint8)
    rgba = rng.integers(0, 256, (17, 29, 4), np.uint8)
    gray = rng.integers(0, 256, (19, 31), np.uint8)
    for name, img in (("rgb", rgb), ("rgba", rgba), ("gray", gray)):
        p = str(tmp_path / f"{name}.png")
        cv2.imwrite(p, img)
        want = cv2.imread(p)[:, :, ::-1].astype(np.float32).transpose(2, 0, 1) / 255.0
        got = t_subject.read_rgb(p)
        assert got.dtype == np.float32 and np.array_equal(got, want), name
    raw = decode_png_native(str(tmp_path / "gray.png"))
    assert raw.shape == (1, 19, 31)
    assert np.array_equal(raw[0], gray.astype(np.float32) / 255.0)


def test_png_writer_read_back(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (21, 33, 3), np.uint8)
    gray = rng.integers(0, 256, (14, 9), np.uint8)
    p_rgb, p_gray = str(tmp_path / "rgb.png"), str(tmp_path / "gray.png")
    write_png(p_rgb, rgb)
    write_png(p_gray, gray)
    assert np.array_equal(cv2.imread(p_rgb)[:, :, ::-1], rgb)
    assert np.array_equal(cv2.imread(p_gray, cv2.IMREAD_UNCHANGED), gray)
    assert np.array_equal(decode_png_native(p_rgb), rgb.transpose(2, 0, 1) / np.float32(255.0))
    # save_image quantizes as the JAX apps' cv2.imwrite of clip(img) * 255 does
    img = rng.uniform(-0.2, 1.2, (8, 10, 3)).astype(np.float32)
    p = str(tmp_path / "img.png")
    save_image(p, torch.from_numpy(img))
    assert np.array_equal(cv2.imread(p)[:, :, ::-1], (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(TypeError):
        write_png(p, img)
