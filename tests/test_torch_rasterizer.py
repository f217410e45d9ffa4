"""Rasterizer of the PyTorch port against the JAX package on the CPU.

* projection: same numpy scene, radius exact;
* binning: the integers (order, tile_indices, pair_rank, tid, flags,
  tile_counts, n_dropped_pairs, n_truncated) equal the JAX package's on the
  SAME screen-space inputs (the JAX projection's outputs as numpy: a 1-ulp
  difference in mean2d can move a tile boundary);
* both plain composites against the Pallas kernels in interpret mode, at
  img/mask 2e-3 and depth 5e-3: log-space against sequential transmittance,
  the kernel tolerances of tests/test_goldens.py;
* the dense plain composite against jax_ref at 1e-6;
* ``rasterize`` against tests/goldens/scene*.npz at the reference
  tolerances: img/mask 1e-6, depth 1e-5, radius exact;
* the wrappers' dispatch: CPU tensors take the plain version, other
  devices raise.
"""
import glob
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core import camera as jcam
from exavatar_release_tpu.core.camera import Camera as JCamera
from exavatar_release_tpu.ops.rasterizer import binning as jb
from exavatar_release_tpu.ops.rasterizer import jax_ref
from exavatar_release_tpu.ops.rasterizer import pallas_kernels as pk
from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians as j_project
from exavatar_release_tpu_torch.core import camera as tcam
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize
from exavatar_release_tpu_torch.ops.rasterizer import binning as tb
from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from exavatar_release_tpu_torch.ops.rasterizer.preprocess import project_gaussians as t_project
from torch_windows import ragged, windows

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDENS = sorted(glob.glob(osp.join(osp.dirname(osp.abspath(__file__)), "goldens", "*.npz")))
KERNEL_TOL = {"img": 2e-3, "mask": 2e-3, "depth": 5e-3}


def _scene(rng, n=300, H=64, W=256, focal=150.0):
    z = rng.uniform(2.0, 4.0, (n, 1))
    x = rng.uniform(-0.55, 0.55, (n, 1)) * (W / focal) * z
    y = rng.uniform(-0.55, 0.55, (n, 1)) * (H / focal) * z
    q = rng.normal(size=(n, 4))
    d = dict(
        means3d=np.concatenate([x, y, z], 1),
        scales=np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 3))),
        quats=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacities=rng.uniform(0.2, 0.99, (n, 1)),
        rgbs=rng.uniform(0, 1, (n, 3)),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["means3d"][:5, 2] = 0.1  # behind the near plane: culled
    d["live"] = np.ones(n, bool)
    d["live"][5:10] = False
    cam = dict(R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
               focal=np.asarray([focal, focal], np.float32),
               princpt=np.asarray([W / 2.0, H / 2.0], np.float32))
    return d, cam, (H, W)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def scene():
    d, cam, shape = _scene(np.random.default_rng(3))
    js = j_project(**_j(d), cam=JCamera(**_j(cam)), img_shape=shape)
    return d, cam, shape, js


def test_camera_helpers():
    focal = np.asarray([1200.0, 1100.0], np.float32)
    np.testing.assert_allclose(tcam.get_fov(torch.from_numpy(focal), (1080, 1920)).numpy(),
                               np.asarray(jcam.get_fov(jnp.asarray(focal), (1080, 1920))),
                               rtol=1e-6)
    eye, target, up = (np.asarray(v, np.float32) for v in
                       ([1.0, -0.5, -2.0], [0.1, 0.2, 0.3], [0.0, -1.0, 0.0]))
    for got, want in zip(tcam.look_at(*map(torch.from_numpy, (eye, target, up))),
                         jcam.look_at(*map(jnp.asarray, (eye, target, up)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_projection(scene):
    d, cam, shape, js = scene
    ts = t_project(**_t(d), cam=TCamera(**_t(cam)), img_shape=shape)
    np.testing.assert_array_equal(ts.radius.numpy(), np.asarray(js.radius))
    np.testing.assert_array_equal(ts.in_frustum.numpy(), np.asarray(js.in_frustum))
    for f in ("params", "color", "mean2d", "depth", "extent"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def _screen_inputs(js):
    """The JAX projection's screen-space outputs, for both binnings."""
    keys = ("mean2d", "radius", "depth", "in_frustum", "extent")
    return {k: np.array(getattr(js, k)) for k in keys}


@pytest.mark.parametrize("max_pairs", [0, 200], ids=["ample", "tight"])
def test_binning_compact_integers(scene, max_pairs):
    *_, shape, js = scene
    s = _screen_inputs(js)
    n = s["depth"].shape[0]
    mp = max_pairs if max_pairs else 16 * n
    kw = dict(img_shape=shape, tile_h=16, tile_w=64, max_per_tile=24, max_pairs=mp)
    want = jb.bin_gaussians_compact(*(jnp.asarray(s[k]) for k in s if k != "extent"),
                                    extent=jnp.asarray(s["extent"]), **kw)
    got = tb.bin_gaussians_compact(*(torch.from_numpy(s[k]) for k in s if k != "extent"),
                                   extent=torch.from_numpy(s["extent"]), **kw)
    if max_pairs:
        assert int(want.n_dropped_pairs) > 0  # the budget binds
    else:
        assert int(want.n_truncated) > 0  # the per-tile cap binds
    assert got.num_tiles == want.num_tiles
    for f in ("order", "tile_indices", "tile_counts", "n_dropped_pairs", "n_truncated"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("max_pairs", [0, 200], ids=["ample", "tight"])
def test_binning_ragged_integers(scene, max_pairs):
    *_, shape, js = scene
    s = _screen_inputs(js)
    kw = dict(img_shape=shape, tile_h=16, tile_w=64, chunk=128, max_pairs=max_pairs)
    want = jb.bin_gaussians_ragged(*(jnp.asarray(s[k]) for k in s if k != "extent"),
                                   extent=jnp.asarray(s["extent"]), **kw)
    got = tb.bin_gaussians_ragged(*(torch.from_numpy(s[k]) for k in s if k != "extent"),
                                  extent=torch.from_numpy(s["extent"]), **kw)
    if max_pairs:
        assert int(want.n_dropped_pairs) > 0
    for f in ("order", "pair_rank", "tid", "flags", "tile_counts", "n_dropped_pairs",
              "n_truncated"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _full_from_ref(accum, tfinal, bg):
    accum, tfinal = np.asarray(accum), np.asarray(tfinal)
    rgb = accum[..., :3] + tfinal * bg[None, None, :]
    return np.concatenate([rgb, accum[..., 3:4], 1.0 - tfinal], -1).transpose(0, 2, 1)


def _errs(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    return {"img": d[:, 0:3].max(), "depth": d[:, 3].max(), "mask": d[:, 4].max()}


def test_plain_dense_vs_jax_ref():
    win, counts, origins = windows(np.random.default_rng(5))
    bg = np.asarray([1.0, 0.5, 0.25], np.float32)
    acc, tf = jax_ref.composite_tiles_ref(
        jnp.asarray(win[:, :8].transpose(0, 2, 1)), jnp.asarray(win[:, 8:].transpose(0, 2, 1)),
        (8, 32), tile_origins=jnp.asarray(origins),
    )
    got = kn.composite_tiles_fwd_cm_plain(*_t(dict(w=win, c=counts, o=origins, b=bg)).values(),
                                          (8, 32))
    want = _full_from_ref(acc, tf, bg)
    assert (want[:, 4] > 1 - 2e-4).any()  # some pixels terminated
    assert max(_errs(got, want).values()) <= 1e-6


def test_plain_dense_vs_pallas_interpret():
    win, counts, origins = windows(np.random.default_rng(6))
    bg = np.asarray([1.0, 0.5, 0.25], np.float32)
    want = pk.composite_tiles_fwd_cm(jnp.asarray(win), jnp.asarray(counts),
                                     jnp.asarray(origins), jnp.asarray(bg), (8, 32),
                                     chunk=128, interpret=True)
    got = kn.composite_tiles_fwd_cm(torch.from_numpy(win), torch.from_numpy(counts),
                                    torch.from_numpy(origins), torch.from_numpy(bg), (8, 32))
    err = _errs(got, want)
    assert all(err[k] <= KERNEL_TOL[k] for k in KERNEL_TOL), err


def test_plain_ragged_vs_pallas_interpret():
    win, counts, _ = windows(np.random.default_rng(7))
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    rows, tid, flags = ragged(win, counts, 128)
    args = (rows, tid, flags, bg)
    want = pk.composite_pairs_fwd_rg(*map(jnp.asarray, args), jnp.float32(0.0), (8, 32),
                                     2, 128, 2, interpret=True)
    got = kn.composite_pairs_fwd_rg(*map(torch.from_numpy, args), 0.0, (8, 32), 2, 128, 2)
    err = _errs(got, want)
    assert all(err[k] <= KERNEL_TOL[k] for k in KERNEL_TOL), err
    # and the ragged plain version equals the dense one on the same rows
    origins = np.asarray([[0, 0], [32, 0]], np.float32)
    dense = kn.composite_tiles_fwd_cm_plain(*_t(dict(w=win, c=counts, o=origins, b=bg)).values(),
                                            (8, 32))
    assert torch.equal(got, dense)


def test_ragged_tile_slots():
    # tile 0: slots 0-1; tile 1: slot 2; tile 2: slots 3-5; slot 6 invalid
    tid = torch.tensor([0, 0, 1, 2, 2, 2, 2], dtype=torch.int32)
    flags = torch.tensor([5, 4, 7, 5, 4, 6, 0], dtype=torch.int32)
    start, count = kn.ragged_tile_slots(tid, flags, 3)
    assert start.tolist() == [0, 2, 3] and count.tolist() == [2, 1, 3]


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 12, 8, device="meta")
    with pytest.raises(ValueError):
        kn.composite_tiles_fwd_cm(meta, torch.zeros(2, dtype=torch.int32),
                                  torch.zeros(2, 2), torch.ones(3), (8, 32))
    with pytest.raises(ValueError):
        kn.composite_pairs_fwd_rg(torch.empty(12, 128, device="meta"),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.full((1,), 7, dtype=torch.int32), torch.ones(3), 0.0,
                                  (8, 32), 1, 128, 1)


def _golden_settings():
    base = dict(tile_h=8, tile_w=128, max_per_tile=64, chunk=32)
    return {"ref": RasterizeSettings(backend="ref", **base),
            "dense": RasterizeSettings(**base),
            "pair_major": RasterizeSettings(pair_major=True, **base)}


@pytest.mark.parametrize("mode", ["ref", "dense", "pair_major"])
@pytest.mark.parametrize("path", GOLDENS, ids=[osp.basename(p) for p in GOLDENS])
def test_rasterize_matches_golden(path, mode):
    d = dict(np.load(path))
    H, W = int(d["H"]), int(d["W"])
    f = float(d["focal"])
    cam = TCamera(torch.eye(3), torch.zeros(3), torch.tensor([f, f]),
                  torch.tensor([W / 2.0, H / 2.0]))
    args = [torch.from_numpy(d[k]) for k in ("means3d", "scales", "quats", "opacities", "rgbs",
                                              "live")]
    out = rasterize(*args, cam, (H, W), torch.from_numpy(d["bg"]), _golden_settings()[mode])
    np.testing.assert_allclose(out["img"].numpy(), d["img"], atol=1e-6)
    np.testing.assert_allclose(out["mask"].numpy(), d["mask"], atol=1e-6)
    np.testing.assert_allclose(out["depth"].numpy(), d["depth"], atol=1e-5)
    np.testing.assert_array_equal(out["radius"].numpy(), d["radius"])
    assert int(out["n_dropped"]) == 0
