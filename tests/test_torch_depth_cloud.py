"""``data/depth_cloud.py`` of the PyTorch port against the JAX package's on
the CPU, on the 8 x 12 synthetic body posed 4 m in front of a 32 x 40
camera: ``render_smplx_depth`` covers the same pixels with depths within
1e-5; ``align_depth_to_smplx`` (a relative depth that is an affine map of a
seeded metric field) and the accumulator's cloud over two frames agree
within 1e-6 + 1e-6 relative (the port takes the render's mean and deviation
in float64, the JAX package in float32: a few float32 ulps of a depth), and
``save_bkg_point_cloud`` writes the same bytes."""
import numpy as np
import torch

from exavatar_release_tpu.data import depth_cloud as jdc
from exavatar_release_tpu_torch.data import depth_cloud as tdc
from exavatar_release_tpu_torch.models.smplx import SMPLXParams, smplx_forward, \
    synthetic_smplx_assets
from torch_frame_fixture import fast_jit

torch.set_num_threads(2)

# the JAX rasterizer as one program: run op by op it costs ~100 compiles
J_RASTER = fast_jit(jdc.rasterize_mesh, static_argnums=(4,))

H, W = 32, 40
FOCAL, PRINCPT = np.asarray([60.0, 61.0], np.float32), np.asarray([W / 2, H / 2], np.float32)


def posed_body(seed):
    """(V, 3) float32 camera-space vertices and (F, 3) faces of the 8 x 12
    synthetic body, root turned to face the camera, 4 m away."""
    rng = np.random.default_rng(seed)
    a = synthetic_smplx_assets(rings=8, segs=12, device="cpu")
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    p = SMPLXParams(betas=torch.zeros(a.num_shape), expr=torch.zeros(a.num_expr),
                    root_pose=f(np.asarray([np.pi, 0, 0]) + rng.normal(0, 0.1, 3)),
                    body_pose=f(rng.normal(0, 0.1, (21, 3))), jaw_pose=torch.zeros(3),
                    leye_pose=torch.zeros(3), reye_pose=torch.zeros(3),
                    lhand_pose=torch.zeros(15, 3), rhand_pose=torch.zeros(15, 3),
                    trans=f([0.0, 0.1, 4.0]))
    with torch.no_grad():
        v = smplx_forward(a, p, with_landmarks=False).vertices
    return v.numpy(), a.faces.numpy()


def test_render_align_accumulate_save(tmp_path, monkeypatch):
    monkeypatch.setattr(jdc, "rasterize_mesh", J_RASTER)
    rng = np.random.default_rng(0)
    acc_j, acc_t = jdc.BkgCloudAccumulator((H, W)), tdc.BkgCloudAccumulator((H, W))
    for frame in range(2):
        verts, faces = posed_body(frame)
        want = jdc.render_smplx_depth(verts, faces, FOCAL, PRINCPT, (H, W))
        got = tdc.render_smplx_depth(torch.from_numpy(verts), faces, FOCAL, PRINCPT, (H, W))
        assert got.dtype == torch.float32 and got.shape == (H, W)
        got = got.numpy()
        assert 50 < (want > 0).sum() < H * W
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, atol=1e-5)

        # a relative depth that is an affine map of a metric field (the
        # mesh's render over a seeded plane), LOW = close
        field = np.where(want > 0, want, rng.uniform(3.0, 4.0) + 0.02 * np.arange(W)[None])
        rel = (rng.uniform(1, 2) * field + rng.uniform(-1, 1)).astype(np.float32)
        aligned_j = jdc.align_depth_to_smplx(rel, want)
        aligned_t = tdc.align_depth_to_smplx(torch.from_numpy(rel), torch.from_numpy(want))
        assert aligned_t.dtype == torch.float32
        np.testing.assert_allclose(aligned_t.numpy(), aligned_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(aligned_t.numpy()[want > 0], want[want > 0], atol=1e-4)

        img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        mask = (want > 0).astype(np.float32)
        acc_j.add(aligned_j, img, mask)
        acc_t.add(aligned_t, torch.from_numpy(img), torch.from_numpy(mask))

    # fewer than 16 mesh pixels: the relative depth comes back unchanged
    few = np.zeros((H, W), np.float32)
    few[0, :15] = 2.0
    np.testing.assert_array_equal(
        tdc.align_depth_to_smplx(torch.from_numpy(rel), torch.from_numpy(few)).numpy(),
        jdc.align_depth_to_smplx(rel, few))

    cloud_j = acc_j.point_cloud(FOCAL, PRINCPT)
    cloud_t = acc_t.point_cloud(FOCAL, PRINCPT)
    assert cloud_t.dtype == torch.float32 and cloud_t.shape == cloud_j.shape
    assert cloud_j.shape[0] == int((acc_j.count > 0).sum()) > H * W // 2, cloud_j.shape
    np.testing.assert_allclose(cloud_t.numpy(), cloud_j, rtol=1e-6, atol=1e-6)
    tdc.save_bkg_point_cloud(str(tmp_path / "t.txt"), cloud_t)
    jdc.save_bkg_point_cloud(str(tmp_path / "j.txt"), cloud_t.numpy())
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
