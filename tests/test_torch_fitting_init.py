"""``core/geometry.py`` and ``data/fitting_init.py`` of the PyTorch port
against the JAX package's on the same numpy inputs, on the CPU: ``umeyama``
with and without scale, ``covariance_from_scale_quat`` and
``transform_points_homogeneous`` (atol 1e-5, float32 on both sides), every
``fitting_init`` function (the rotations and translations 1e-5; the pure
numpy ones exactly) and ``load_xhumans_smplx_init`` on a seeded pkl
directory (exactly)."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core import geometry as jg
from exavatar_release_tpu.data import fitting_init as jfi
from exavatar_release_tpu_torch.core import geometry as tg
from exavatar_release_tpu_torch.data import fitting_init as tfi
from torch_frame_fixture import fast_jit

torch.set_num_threads(2)

# the JAX functions as one program each: run op by op they cost ~100 compiles
J_UMEYAMA = fast_jit(jg.umeyama, static_argnums=(2,))
J_AA_TO_MATRIX = fast_jit(jfi.axis_angle_to_matrix)
J_MATRIX_TO_AA = fast_jit(jfi.matrix_to_axis_angle)


@pytest.fixture(autouse=True)
def _jitted_jax(monkeypatch):
    monkeypatch.setattr(jfi, "umeyama", J_UMEYAMA)
    monkeypatch.setattr(jfi, "axis_angle_to_matrix", J_AA_TO_MATRIX)
    monkeypatch.setattr(jfi, "matrix_to_axis_angle", J_MATRIX_TO_AA)

ATOL = 1e-5


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(tg.quaternion_to_matrix(torch.from_numpy(q.astype(np.float32))))


@pytest.mark.parametrize("estimate_scale", [True, False])
def test_umeyama(estimate_scale):
    rng = np.random.default_rng(3)
    src = rng.normal(size=(64, 3)).astype(np.float32)
    R0, t0, s0 = _rotation(rng), rng.normal(size=3), 1.7
    dst = (s0 * src @ R0.T + t0 + rng.normal(0, 0.01, (64, 3))).astype(np.float32)
    want = J_UMEYAMA(jnp.asarray(src), jnp.asarray(dst), estimate_scale)
    got = tg.umeyama(torch.from_numpy(src), torch.from_numpy(dst), estimate_scale=estimate_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), R0, atol=1e-2)  # it recovers the rotation
    if estimate_scale:
        assert abs(float(got[2]) - s0) < 0.05
    else:
        assert float(got[2]) == 1.0
    # a reflection in the least-squares answer is turned into a rotation
    mirrored = src * np.asarray([1, 1, -1], np.float32)
    R, _, _ = tg.umeyama(torch.from_numpy(src), torch.from_numpy(mirrored), estimate_scale)
    Rj, _, _ = J_UMEYAMA(jnp.asarray(src), jnp.asarray(mirrored), estimate_scale)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=ATOL)


def test_covariance_and_homogeneous_transform():
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.01, 0.3, (20, 3)).astype(np.float32)
    quat = rng.normal(size=(20, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tg.covariance_from_scale_quat(torch.from_numpy(scale), torch.from_numpy(quat)).numpy(),
        np.asarray(jg.covariance_from_scale_quat(jnp.asarray(scale), jnp.asarray(quat))),
        atol=1e-7)
    T = rng.normal(size=(5, 4, 4)).astype(np.float32)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tg.transform_points_homogeneous(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
        np.asarray(jg.transform_points_homogeneous(jnp.asarray(T), jnp.asarray(pts))), atol=ATOL)


def test_bbox_init_and_crop_intrinsics():
    rng = np.random.default_rng(5)
    for bbox in ([10.0, 20.0, 50.0, 30.0], [10.0, 20.0, 30.0, 50.0]):
        np.testing.assert_array_equal(tfi.set_aspect_ratio(np.asarray(bbox)),
                                      jfi.set_aspect_ratio(np.asarray(bbox)))
    kpt = np.concatenate([rng.uniform(100, 900, (135, 2)), rng.uniform(0, 1, (135, 1))],
                         1).astype(np.float32)
    focal, princpt = np.asarray([1200.0, 1210.0], np.float32), np.asarray([960.0, 540.0])
    np.testing.assert_array_equal(tfi.smplx_trans_init(kpt, focal, princpt),
                                  jfi.smplx_trans_init(kpt, focal, princpt))
    bbox = np.asarray([100.0, 80.0, 200.0, 240.0])
    for g, w in zip(tfi.crop_camera_intrinsics(focal, princpt, bbox, (8, 6)),
                    jfi.crop_camera_intrinsics(focal, princpt, bbox, (8, 6))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tfi.keypoints_to_crop(kpt[:, :2], bbox, (8, 6)),
                                  jfi.keypoints_to_crop(kpt[:, :2], bbox, (8, 6)))


def test_root_inits():
    rng = np.random.default_rng(6)
    smplx_v = rng.normal(0, 0.3, (200, 3)).astype(np.float32)
    face_idx = rng.choice(200, 40, replace=False)
    R = _rotation(rng)
    flame_v = ((smplx_v[face_idx] - smplx_v[face_idx].mean(0)) @ R
               + rng.normal(0, 0.002, (40, 3))).astype(np.float32)
    root = rng.normal(0, 0.5, 3).astype(np.float32)
    trans = np.asarray([0.1, -0.2, 2.5], np.float32)
    got = tfi.flame_root_init(root, trans, smplx_v, face_idx, flame_v)
    want = jfi.flame_root_init(root, trans, smplx_v, face_idx, flame_v)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (3,)
        np.testing.assert_allclose(g, w, atol=ATOL)
    cam_R = _rotation(rng)
    for cr in (cam_R, cam_R.astype(np.float64)):
        np.testing.assert_allclose(tfi.world_to_cam_root_pose(root, cr),
                                   jfi.world_to_cam_root_pose(root, cr), atol=ATOL)


def test_load_xhumans_smplx_init(tmp_path):
    rng = np.random.default_rng(7)
    os.makedirs(tmp_path / "SMPLX")
    for fid in (3, 17, 120):
        d = {"global_orient": rng.normal(size=(1, 3)), "body_pose": rng.normal(size=63),
             "jaw_pose": rng.normal(size=3), "leye_pose": rng.normal(size=3),
             "reye_pose": rng.normal(size=3), "left_hand_pose": rng.normal(size=45),
             "right_hand_pose": rng.normal(size=(15, 3))}
        if fid != 17:  # a file without ``transl`` gets zeros
            d["transl"] = rng.normal(size=3)
        with open(tmp_path / "SMPLX" / f"mesh-f{fid:05d}_smplx.pkl", "wb") as f:
            pickle.dump(d, f)
    got, want = tfi.load_xhumans_smplx_init(str(tmp_path)), jfi.load_xhumans_smplx_init(
        str(tmp_path))
    assert sorted(got) == sorted(want) == [3, 17, 120]
    for fid in want:
        assert set(got[fid]) == set(want[fid])
        for k in want[fid]:
            assert got[fid][k].dtype == np.float32
            np.testing.assert_array_equal(got[fid][k], want[fid][k])
    assert not got[17]["trans"].any()
