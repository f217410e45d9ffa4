"""Golden-file parity: frozen oracle tensors pin the rasterizer semantics.

tests/goldens/scene{i}.npz hold inputs + jax_ref forward outputs + input
gradients, generated once by tools/make_goldens.py (BASELINE
gradient-correctness gate; the committed tensors guard against silent
semantic drift and stand ready to be diffed against a CUDA capture of
diff-gaussian-rasterization-depth on the same inputs — see PARITY.md).
"""
import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exavatar_release_tpu.core.camera import Camera
from exavatar_release_tpu.ops.rasterizer import RasterizeSettings, rasterize
from fast_compile import fast_jit

GOLDENS = sorted(
    glob.glob(osp.join(osp.dirname(osp.abspath(__file__)), "goldens", "*.npz"))
)
REF = RasterizeSettings(backend="ref", tile_h=8, tile_w=128, max_per_tile=64, chunk=32)
PAL = RasterizeSettings(
    backend="pallas", tile_h=8, tile_w=128, max_per_tile=64, chunk=32, interpret=True
)

assert GOLDENS, "tests/goldens/*.npz missing — run tools/make_goldens.py"


def _setup(d):
    cam = Camera(
        R=jnp.eye(3), t=jnp.zeros(3),
        focal=jnp.asarray([d["focal"], d["focal"]]),
        princpt=jnp.asarray([d["W"] / 2.0, d["H"] / 2.0]),
    )
    img_shape = (int(d["H"]), int(d["W"]))
    args = tuple(jnp.asarray(d[k]) for k in
                 ("means3d", "scales", "quats", "opacities", "rgbs"))
    return cam, img_shape, args, jnp.asarray(d["live"]), jnp.asarray(d["bg"])


def _loss(r, img_shape):
    H, W = img_shape
    wimg = (jnp.arange(H * W * 3, dtype=jnp.float32)
            .reshape(H, W, 3) % 7.0 + 1.0) / 7.0
    wd = (jnp.arange(H * W, dtype=jnp.float32).reshape(H, W) % 5.0 + 1.0) / 5.0
    return (jnp.sum(r["img"] * wimg) + jnp.sum(r["depth"] * wd)
            + jnp.sum(r["mask"] * wd.T.reshape(H, W)))


@pytest.mark.parametrize("path", GOLDENS, ids=[osp.basename(p) for p in GOLDENS])
@pytest.mark.parametrize("settings", [REF, PAL], ids=["ref", "pallas_interpret"])
def test_matches_golden(path, settings):
    d = dict(np.load(path))
    cam, img_shape, args, live, bg = _setup(d)

    out = fast_jit(rasterize, static_argnums=(7, 9))(
        *args, live, cam, img_shape, bg, settings)
    # oracle backend must reproduce its own frozen tensors near-exactly; the
    # Pallas kernels within log-space-compositing f32 tolerance (scene2/3
    # stress the 0.99 alpha clamp and the 1e-4 termination boundary, where
    # log1p/exp round-trips cost a few extra ulps vs the sequential product)
    tol = dict(atol=1e-6) if settings.backend == "ref" else dict(atol=2e-3)
    np.testing.assert_allclose(np.asarray(out["img"]), d["img"], **tol)
    np.testing.assert_allclose(
        np.asarray(out["mask"]), d["mask"],
        atol=1e-6 if settings.backend == "ref" else 2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(out["depth"]), d["depth"],
        atol=1e-5 if settings.backend == "ref" else 5e-3,
    )
    np.testing.assert_allclose(np.asarray(out["radius"]), d["radius"], atol=0)

    grads = fast_jit(jax.grad(
        lambda *a: _loss(rasterize(*a, live, cam, img_shape, bg, settings),
                         img_shape),
        argnums=(0, 1, 2, 3, 4),
    ))(*args)
    names = ("g_means3d", "g_scales", "g_quats", "g_opacities", "g_rgbs")
    for g, name in zip(grads, names):
        ref = d[name]
        scale = max(1.0, float(np.abs(ref).max()))
        gtol = 1e-5 if settings.backend == "ref" else 2.5e-2
        np.testing.assert_allclose(
            np.asarray(g) / scale, ref / scale, atol=gtol, err_msg=name
        )
