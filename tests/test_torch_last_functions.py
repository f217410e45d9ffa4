"""The last functions of the JAX package to be ported, each against the JAX
function on the same numpy inputs, on the CPU:

* ``core/camera.py``: ``world_to_cam``, ``cam_to_world``, ``cam_to_pixel``,
  ``pixel_to_cam`` (1e-5), ``get_view_matrix`` (1e-7), ``get_proj_matrix``
  and ``full_projection`` (1e-6), the tolerances of tests/test_sh_camera.py;
  the two that run through atan and tan under the seam of
  tests/torch_xla_math.py (XLA's transcendentals for the port's) and, as the
  ``torch_libm`` case, on the port's own libm;
* ``core/sh.py:eval_sh`` at degrees 0-4 (1e-5), asserting as JAX's does;
* ``core/rotations.py:quaternion_multiply`` (1e-6);
* ``fitting/keypoints.py:flame_full_keypoints`` on the port's ``SMPLXOutput``
  (exact: a concatenation);
* ``ops/rasterizer/binning.py:bin_gaussians_scan`` exactly equal to JAX's on
  tests/gs_scene.py's 200-Gaussian 64x256 scene (the JAX projection's
  screen-space outputs as numpy); and the port's ``bin_gaussians_sorted``
  and ``bin_gaussians_compact`` held to the port's scan exactly, as
  tests/test_rasterizer.py:216-265 holds JAX's, the compact one also under a
  pair budget that binds (each tile keeps a prefix of the scan's window),
  and with the projection's tight extents on both sides;
* ``models/smplx/structs.py:np_faces``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core import camera as jcam
from exavatar_release_tpu.core import rotations as jrot
from exavatar_release_tpu.core import sh as jsh
from exavatar_release_tpu.fitting import keypoints as jkp
from exavatar_release_tpu.models.smplx import structs as jst
from exavatar_release_tpu.ops.rasterizer import binning as jb
from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians as j_project
from exavatar_release_tpu_torch.core import camera as tcam
from exavatar_release_tpu_torch.core import rotations as trot
from exavatar_release_tpu_torch.core import sh as tsh
from exavatar_release_tpu_torch.fitting import keypoints as tkp
from exavatar_release_tpu_torch.models.smplx import structs as tst
from exavatar_release_tpu_torch.ops.rasterizer import binning as tb
from gs_scene import make_scene
from torch_port_fixture import fast_jit
from torch_xla_math import xla_transcendentals

torch.set_num_threads(2)

T = torch.from_numpy
BINNING_FIELDS = ("order", "tile_counts", "tile_indices")


def _rotation(rng):
    q = rng.normal(size=4)
    return np.array(jrot.quaternion_to_matrix(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))


def test_world_cam_pixel_transforms():
    rng = np.random.default_rng(0)
    R, t = _rotation(rng), rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    focal = np.asarray([400.0, 450.0], np.float32)
    princpt = np.asarray([256.0, 128.0], np.float32)
    cam_pts = pts + np.asarray([0, 0, 4.0], np.float32)
    cases = [
        (tcam.world_to_cam(T(pts), T(R), T(t)), jcam.world_to_cam(pts, R, t)),
        (tcam.cam_to_world(T(pts), T(R), T(t)), jcam.cam_to_world(pts, R, t)),
        (tcam.cam_to_pixel(T(cam_pts), T(focal), T(princpt)),
         jcam.cam_to_pixel(cam_pts, focal, princpt)),
        (tcam.pixel_to_cam(T(cam_pts), T(focal), T(princpt)),
         jcam.pixel_to_cam(cam_pts, focal, princpt)),
    ]
    for i, (got, want) in enumerate(cases):
        assert got.dtype == torch.float32 and got.shape == np.shape(want), i
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5,
                                   err_msg=str(i))
    back = tcam.cam_to_world(tcam.world_to_cam(T(pts), T(R), T(t)), T(R), T(t))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    pix = tcam.cam_to_pixel(T(cam_pts), T(focal), T(princpt))
    np.testing.assert_allclose(tcam.pixel_to_cam(pix, T(focal), T(princpt)).numpy(), cam_pts,
                               atol=1e-5)


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_view_and_projection_matrices(seam):
    rng = np.random.default_rng(1)
    R, t = _rotation(rng), rng.normal(size=3).astype(np.float32)
    V = tcam.get_view_matrix(T(R), T(t))
    assert V.shape == (4, 4) and V.dtype == torch.float32
    np.testing.assert_allclose(V.numpy(), np.asarray(jcam.get_view_matrix(R, t)), atol=1e-7)
    focal = np.asarray([500.0, 600.0], np.float32)
    princpt = np.asarray([320.0, 240.0], np.float32)
    with xla_transcendentals(seam):  # atan, tan
        P = tcam.get_proj_matrix(T(focal), (480, 640), 0.05, 50.0)
        full = tcam.full_projection(tcam.Camera(T(R), T(t), T(focal), T(princpt)), (480, 640))
    np.testing.assert_allclose(
        P.numpy(), np.asarray(jcam.get_proj_matrix(jnp.asarray(focal), (480, 640), 0.05, 50.0)),
        atol=1e-6)
    want = jcam.full_projection(jcam.Camera(*map(jnp.asarray, (R, t, focal, princpt))),
                                (480, 640))
    assert full.dtype == torch.float32
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-6)


def test_eval_sh_static_degrees():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sh = rng.normal(size=(40, 3, 25)).astype(np.float32)
    for deg in range(5):
        want = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
        got = tsh.eval_sh(deg, T(sh), T(d))
        assert got.shape == want.shape == (40, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=str(deg))
        # the static degree is the dynamic one at that degree
        np.testing.assert_allclose(
            got.numpy(), tsh.eval_sh_dynamic(float(deg), T(sh[..., :(deg + 1) ** 2]), T(d)).numpy(),
            atol=1e-5)
    for deg, bands in ((5, 25), (2, 4)):  # no degree 5; too few bands for degree 2
        with pytest.raises(AssertionError):
            jsh.eval_sh(deg, jnp.asarray(sh[..., :bands]), jnp.asarray(d))
        with pytest.raises(AssertionError):
            tsh.eval_sh(deg, T(sh[..., :bands]), T(d))


def test_quaternion_multiply():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(7, 5, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)  # broadcast over the leading axis
    got = trot.quaternion_multiply(T(a), T(b))
    want = np.asarray(jrot.quaternion_multiply(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (7, 5, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the product of rotations: q(a) q(b) is the matrix product
    qa, qb = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (a[0], b))
    np.testing.assert_allclose(
        trot.quaternion_to_matrix(trot.quaternion_multiply(T(qa), T(qb))).numpy(),
        (trot.quaternion_to_matrix(T(qa)) @ trot.quaternion_to_matrix(T(qb))).numpy(), atol=1e-5)


def test_flame_full_keypoints():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrays = dict(vertices=f(300, 3), joints=f(5, 3), landmarks=f(68, 3), v_shaped=f(300, 3),
                  joints_zero_pose=f(5, 3), rel_transforms=f(5, 4, 4))
    j_out = jst.SMPLXOutput(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t_out = tst.SMPLXOutput(**{k: T(v) for k, v in arrays.items()})
    want = np.asarray(jkp.flame_full_keypoints(j_out, 17, 233))
    got = tkp.flame_full_keypoints(t_out, 17, 233)
    assert got.shape == want.shape == (tkp.FLAME_KPT_NUM, 3) and jkp.FLAME_KPT_NUM == 75
    np.testing.assert_array_equal(got.numpy(), want)


def test_np_faces():
    faces = np.random.default_rng(5).integers(0, 1000, (40, 3))
    want = jst.np_faces(jnp.asarray(faces, jnp.int32))
    for given in (faces, torch.from_numpy(faces), torch.from_numpy(faces).int()):
        got = tst.np_faces(given)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def screen():
    """tests/test_rasterizer.py's binning scene, projected by the JAX
    package: its screen-space outputs as numpy."""
    sc = make_scene(np.random.default_rng(0), n=200, img=(64, 256))
    s = fast_jit(j_project, static_argnums=(7,))(
        sc["means3d"], sc["scales"], sc["quats"], sc["opacities"], sc["rgbs"], sc["live"],
        sc["cam"], sc["img_shape"])
    return {k: np.array(getattr(s, k)) for k in ("mean2d", "radius", "depth", "in_frustum",
                                                  "extent")}


ARGS = ((64, 256), 8, 128, 128)  # img_shape, tile_h, tile_w, max_per_tile


def _t_args(s):
    return [T(s[k]) for k in ("mean2d", "radius", "depth", "in_frustum")]


def test_bin_gaussians_scan_equals_jax(screen):
    want = jb.bin_gaussians_scan(*(jnp.asarray(screen[k]) for k in
                                   ("mean2d", "radius", "depth", "in_frustum")), *ARGS)
    got = tb.bin_gaussians_scan(*_t_args(screen), *ARGS)
    assert got.num_tiles == want.num_tiles == (8, 2)
    assert int(np.asarray(want.tile_counts).max()) > 1
    for f in BINNING_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert int(got.n_dropped_pairs) == 0 and int(got.n_truncated) == 0


@pytest.mark.parametrize("extent", [False, True], ids=["radius", "extent"])
def test_port_binnings_match_the_port_scan(screen, extent):
    kw = {"extent": T(screen["extent"])} if extent else {}
    oracle = tb.bin_gaussians_scan(*_t_args(screen), *ARGS, **kw)
    n = screen["depth"].shape[0]
    for name, b in (("sorted", tb.bin_gaussians_sorted(*_t_args(screen), *ARGS,
                                                        max_tiles_per_gaussian=64, **kw)),
                    ("compact", tb.bin_gaussians_compact(*_t_args(screen), *ARGS,
                                                          max_pairs=64 * n, **kw))):
        assert int(b.n_dropped_pairs) == 0, name
        for f in BINNING_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(oracle, f).numpy(),
                                          err_msg=f"{name} {f}")
    # a pair budget that binds drops the deepest pairs: every window stays a
    # prefix of the scan's
    cap = 64
    c = tb.bin_gaussians_compact(*_t_args(screen), *ARGS, max_pairs=cap, **kw)
    cc = c.tile_counts.numpy()
    assert cc.sum() <= cap and int(c.n_dropped_pairs) > 0
    full, capped = oracle.tile_indices.numpy(), c.tile_indices.numpy()
    for t in range(full.shape[0]):
        np.testing.assert_array_equal(capped[t, :cc[t]], full[t, :cc[t]])
