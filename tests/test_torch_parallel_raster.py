"""The port's sharded renders (``exavatar_release_tpu_torch/parallel/
sharded_raster.py``) on a local mesh of CPU devices, against the JAX
package's on the same inputs:

* ``resolve_exchange_cap`` equal to JAX's over a grid of (n, D);
* the band's binning with ``tile_row_offset`` 0-3 (pair-sort and ragged)
  integer for integer against JAX's;
* ``rasterize_sharded`` and ``rasterize_gaussian_sharded`` over four bands
  against JAX's own on ``make_mesh((4,), ("tile",))`` (its virtual CPU
  devices), backend "ref", on tests/gs_scene.py's 96-Gaussian 64x256 scene
  and on a non-divisible N and H: img and mask within 1e-5, depth 1e-4,
  radius exact, mean2d 1e-4, the four input gradients at rtol 1e-5 /
  atol 2e-4 (tests/test_parallel.py's bounds); the per-rank exchange
  overflow at cap 2 equal to JAX's;
* the exchange's deepest-first overflow (tests/test_parallel.py:245) against
  JAX's ``_exchange_to_bands``;
* the dense and pair-major kernel paths (the kernels' plain versions on the
  CPU) sharded over two bands on every tests/goldens scene, against the
  goldens' values (1e-6, depth 1e-5) and input gradients (1e-5 of each
  leaf's largest; 2.5e-2 in scene2, whose front layer clamps), the bounds
  of tests/test_torch_rasterizer.py and tests/test_torch_raster_grad.py.

The JAX references run as one program (``fast_jit``).
"""
import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from exavatar_release_tpu.ops.rasterizer import binning as jb
from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings as JSettings
from exavatar_release_tpu.parallel import make_mesh as j_make_mesh
from exavatar_release_tpu.parallel import sharded_raster as jsr
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.ops.rasterizer import binning as tb
from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings
from exavatar_release_tpu_torch.ops.rasterizer.preprocess import project_gaussians
from exavatar_release_tpu_torch.parallel import make_mesh
from exavatar_release_tpu_torch.parallel import sharded_raster as tsr
from gs_scene import make_scene
from torch_port_fixture import fast_jit

torch.set_num_threads(2)

GOLDENS = sorted(glob.glob(osp.join(osp.dirname(osp.abspath(__file__)), "goldens", "*.npz")))
KEYS = ("means3d", "scales", "quats", "opacities", "rgbs", "live")
GRAD_KEYS = ("means3d", "scales", "opacities", "rgbs")
SCENES = {"n96_64x256": (96, (64, 256)), "n50_50x256": (50, (50, 256))}


@pytest.fixture(scope="module")
def j_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    return j_make_mesh((4,), ("tile",))


def _t_mesh(d):
    return make_mesh((d,), ("tile",), [torch.device("cpu")] * d)


def _t_cam(cam):
    return TCamera(*(torch.from_numpy(np.array(x)) for x in cam))


def _loss(r):
    return (r["img"] ** 2).sum() + r["mask"].sum() + r["depth"].sum()


def _scene(name):
    n, img = SCENES[name]
    return make_scene(np.random.default_rng(0), n=n, img=img)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_resolve_exchange_cap_equals_jax(d):
    for n in (1, 7, 50, 96, 128, 1000, 4097, 100_000, 184_379):
        assert tsr.resolve_exchange_cap(n, d) == jsr.resolve_exchange_cap(n, d), (n, d)


@pytest.fixture(scope="module")
def screen():
    """A projected scene, 128 rows of 8-row tiles, as numpy arrays."""
    sc = make_scene(np.random.default_rng(4), n=120, img=(128, 256))
    s = project_gaussians(*(torch.from_numpy(np.array(sc[k])) for k in KEYS),
                          _t_cam(sc["cam"]), (128, 256))
    return {k: getattr(s, k).numpy() for k in ("mean2d", "radius", "depth", "in_frustum",
                                                "extent")}


@pytest.mark.parametrize("kind", ["sorted", "ragged"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_offset_binning_equals_jax(screen, kind, offset):
    """A 32-row band starting at global tile row ``offset``."""
    args = [screen[k] for k in ("mean2d", "radius", "depth", "in_frustum")]
    kw = dict(extent=screen["extent"], tile_row_offset=offset)
    if kind == "sorted":
        want = jb.bin_gaussians_sorted(*map(jnp.asarray, args), (32, 256), 8, 128, 64,
                                       max_tiles_per_gaussian=16, **kw)
        got = tb.bin_gaussians_sorted(*map(torch.from_numpy, args), (32, 256), 8, 128, 64,
                                      max_tiles_per_gaussian=16, extent=torch.from_numpy(
                                          screen["extent"]), tile_row_offset=offset)
        fields = ("order", "tile_indices", "tile_counts", "n_dropped_pairs", "n_truncated")
    else:
        want = jb.bin_gaussians_ragged(*map(jnp.asarray, args), (32, 256), 8, 128, chunk=128,
                                       max_pairs=600, **kw)
        got = tb.bin_gaussians_ragged(*map(torch.from_numpy, args), (32, 256), 8, 128,
                                      chunk=128, max_pairs=600, extent=torch.from_numpy(
                                          screen["extent"]), tile_row_offset=offset)
        fields = ("order", "pair_rank", "tid", "flags", "tile_counts", "n_dropped_pairs")
    assert int(np.asarray(want.tile_counts).sum()) > 0
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def j_renders(j_mesh):
    """JAX's two sharded renders, value, outputs and input gradients, on
    every scene of SCENES; and the Gaussian-sharded overflow at cap 2: one
    program for all of them."""
    settings = JSettings(backend="ref", max_per_tile=256)
    scenes = {name: _scene(name) for name in SCENES}
    renders = {"sharded": jsr.rasterize_sharded, "gaussian": jsr.rasterize_gaussian_sharded}

    def all_of_them(args):
        out = {}
        for name, sc in scenes.items():
            for render, fn in renders.items():
                def loss(means, scales, opac, rgbs, fn=fn, sc=sc):
                    r = fn(means, scales, sc["quats"], opac, rgbs, sc["live"], sc["cam"],
                           sc["img_shape"], sc["bg"], j_mesh, "tile", settings)
                    return _loss(r), r

                (_, r), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                               has_aux=True)(*args[name])
                out[f"{name}/{render}"] = (r, list(g))
        sc = scenes["n96_64x256"]
        out["overflow_cap2"] = jsr.rasterize_gaussian_sharded(
            *(sc[k] for k in KEYS), sc["cam"], sc["img_shape"], sc["bg"], j_mesh, "tile",
            settings, cap=2)["exchange_overflow"]
        return out

    args = {name: tuple(sc[k] for k in GRAD_KEYS) for name, sc in scenes.items()}
    return jax.tree.map(np.asarray, fast_jit(all_of_them)(args))


def _t_render(render, sc, settings, **kw):
    xs = [torch.from_numpy(np.array(sc[k])) for k in KEYS]
    for i in (0, 1, 3, 4):
        xs[i].requires_grad_(True)
    fn = tsr.rasterize_sharded if render == "sharded" else tsr.rasterize_gaussian_sharded
    r = fn(*xs, _t_cam(sc["cam"]), sc["img_shape"], torch.from_numpy(np.array(sc["bg"])),
           _t_mesh(4), "tile", settings, **kw)
    return r, xs


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("render", ["sharded", "gaussian"])
def test_sharded_render_vs_jax(j_renders, render, scene):
    want, g_want = j_renders[f"{scene}/{render}"]
    r, xs = _t_render(render, _scene(scene), RasterizeSettings(backend="ref", max_per_tile=256))
    _loss(r).backward()
    H = SCENES[scene][1][0]
    assert r["img"].shape == (H, 256, 3) and r["radius"].shape == (SCENES[scene][0],)
    for k, tol in (("img", 1e-5), ("mask", 1e-5), ("depth", 1e-4), ("mean2d", 1e-4)):
        np.testing.assert_allclose(r[k].detach().numpy(), want[k], atol=tol, err_msg=k)
    np.testing.assert_array_equal(r["radius"].detach().numpy(), want["radius"])
    assert int(r["n_dropped"]) == int(want["n_dropped"]) == 0
    if render == "gaussian":
        np.testing.assert_array_equal(r["exchange_overflow"].numpy(), want["exchange_overflow"])
        assert float(r["exchange_bytes"]) == float(want["exchange_bytes"])
    for i, k, gw in zip((0, 1, 3, 4), GRAD_KEYS, g_want):
        np.testing.assert_allclose(xs[i].grad.numpy(), gw, rtol=1e-5, atol=2e-4, err_msg=k)


def test_exchange_overflow_per_rank_vs_jax(j_renders):
    with torch.no_grad():
        r, _ = _t_render("gaussian", _scene("n96_64x256"),
                         RasterizeSettings(backend="ref", max_per_tile=256), cap=2)
    want = j_renders["overflow_cap2"]
    assert want.sum() > 0
    np.testing.assert_array_equal(r["exchange_overflow"].numpy(), want)


def test_overflow_drops_deepest_first_vs_jax(j_mesh):
    """Every Gaussian targets band 0 and every source overflows its band-0
    bucket: the nearest ``cap`` per source are kept, as JAX keeps them."""
    D, cap, n_per = 4, 2, 8
    n = D * n_per
    ids = np.arange(n, dtype=np.float32)
    payload = np.stack([ids, ids * 10.0], axis=1)
    y = np.full((n,), 1.0, np.float32)
    r = np.zeros((n,), np.float32)
    vis = np.ones((n,), bool)
    depth = np.random.default_rng(3).permutation(n).astype(np.float32)

    def fn(pl, yy, rr, vv, dd):
        recv, vrecv, ovf = jsr._exchange_to_bands(pl, yy, rr, vv, "tile", D, 16, cap, depth=dd)
        return recv, vrecv, ovf[None]

    want = fast_jit(jax.shard_map(fn, mesh=j_mesh, in_specs=(P("tile"),) * 5,
                                  out_specs=(P("tile"),) * 3, check_vma=False))(
        *map(jnp.asarray, (payload, y, r, vis, depth)))
    want_recv, want_vrecv, want_ovf = map(np.asarray, want)
    sends, vsends, ovfs = [], [], []
    for s in range(D):
        sl = slice(s * n_per, (s + 1) * n_per)
        send, vsend, ovf = tsr._bucket_for_bands(
            torch.from_numpy(payload[sl]), torch.from_numpy(y[sl]), torch.from_numpy(r[sl]),
            torch.from_numpy(vis[sl]), D, 16, cap, depth=torch.from_numpy(depth[sl]))
        sends.append(send)
        vsends.append(vsend)
        ovfs.append(int(ovf))
    # the all_to_all: rank d receives bucket d of every source, source-major
    recv = torch.cat([torch.cat([x[d * cap:(d + 1) * cap] for x in sends]) for d in range(D)])
    vrecv = torch.cat([torch.cat([x[d * cap:(d + 1) * cap] for x in vsends]) for d in range(D)])
    np.testing.assert_array_equal(recv.numpy(), want_recv)
    np.testing.assert_array_equal(vrecv.numpy(), want_vrecv)
    np.testing.assert_array_equal(ovfs, want_ovf)
    assert sum(ovfs) == D * (n_per - cap)


def _golden(path):
    d = dict(np.load(path))
    H, W = int(d["H"]), int(d["W"])
    f = float(d["focal"])
    cam = TCamera(torch.eye(3), torch.zeros(3), torch.tensor([f, f]),
                  torch.tensor([W / 2.0, H / 2.0]))
    return d, cam, (H, W)


def _golden_loss(r, shape):
    """The fixed cotangent of tests/test_goldens.py:_loss."""
    H, W = shape
    wimg = (torch.arange(H * W * 3, dtype=torch.float32).reshape(H, W, 3) % 7.0 + 1.0) / 7.0
    wd = (torch.arange(H * W, dtype=torch.float32).reshape(H, W) % 5.0 + 1.0) / 5.0
    return ((r["img"] * wimg).sum() + (r["depth"] * wd).sum()
            + (r["mask"] * wd.T.reshape(H, W)).sum())


def _scaled(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("render", ["sharded", "gaussian"])
@pytest.mark.parametrize("pair_major", [False, True], ids=["dense", "pair_major"])
@pytest.mark.parametrize("path", GOLDENS, ids=[osp.basename(p) for p in GOLDENS])
def test_golden_kernel_paths_over_two_bands(path, pair_major, render):
    d, cam, shape = _golden(path)
    settings = RasterizeSettings(tile_h=8, tile_w=128, max_per_tile=64, chunk=32,
                                 pair_major=pair_major)
    xs = [torch.from_numpy(d[k]).requires_grad_(True)
          for k in ("means3d", "scales", "quats", "opacities", "rgbs")]
    fn = tsr.rasterize_sharded if render == "sharded" else tsr.rasterize_gaussian_sharded
    out = fn(*xs, torch.from_numpy(d["live"]), cam, shape, torch.from_numpy(d["bg"]),
             _t_mesh(2), "tile", settings)
    np.testing.assert_allclose(out["img"].detach().numpy(), d["img"], atol=1e-6)
    np.testing.assert_allclose(out["mask"].detach().numpy(), d["mask"], atol=1e-6)
    np.testing.assert_allclose(out["depth"].detach().numpy(), d["depth"], atol=1e-5)
    np.testing.assert_array_equal(out["radius"].detach().numpy(), d["radius"])
    assert int(out["n_dropped"]) == 0
    _golden_loss(out, shape).backward()
    clamps = osp.basename(path) == "scene2.npz"
    for x, name in zip(xs, ("g_means3d", "g_scales", "g_quats", "g_opacities", "g_rgbs")):
        assert _scaled(x.grad.numpy(), d[name]) <= (2.5e-2 if clamps else 1e-5), name
