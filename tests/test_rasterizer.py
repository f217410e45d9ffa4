"""Differential tests for the 3DGS rasterizer.

Strategy (SURVEY.md §4): the sequential-scan JAX oracle defines the CUDA
renderCUDA semantics; the Pallas kernels (interpret mode on CPU) must match
it in forward values AND in gradients (hand-derived VJP vs oracle autodiff),
and both must match finite differences.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from exavatar_release_tpu.ops.rasterizer import RasterizeSettings, rasterize
from fast_compile import fast_jit
from tests.gs_scene import make_scene

REF = RasterizeSettings(backend="ref", tile_h=8, tile_w=128, max_per_tile=64, chunk=32)
PAL = RasterizeSettings(
    backend="pallas", tile_h=8, tile_w=128, max_per_tile=64, chunk=32, interpret=True
)
# one program per render (static: img_shape, settings)
_rasterize = fast_jit(rasterize, static_argnums=(7, 9))


def render(scene, settings, raster=_rasterize, **over):
    """``raster``: ``rasterize`` itself where the render is part of a
    larger program."""
    kw = dict(scene)
    kw.update(over)
    return raster(
        kw["means3d"],
        kw["scales"],
        kw["quats"],
        kw["opacities"],
        kw["rgbs"],
        kw["live"],
        kw["cam"],
        kw["img_shape"],
        kw["bg"],
        settings,
        kw.get("mean2d_offset"),
    )


def test_forward_oracle_matches_pallas(rng):
    scene = make_scene(rng)
    out_ref = render(scene, REF)
    out_pal = render(scene, PAL)
    # ~1e-4 differences stem from log-space transmittance vs the oracle's
    # sequential products — both f32; values live in [0, 1]
    np.testing.assert_allclose(
        np.asarray(out_pal["img"]), np.asarray(out_ref["img"]), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(out_pal["depth"]), np.asarray(out_ref["depth"]), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_pal["mask"]), np.asarray(out_ref["mask"]), atol=2e-4
    )


def test_forward_nontrivial(rng):
    scene = make_scene(rng)
    out = render(scene, REF)
    img = np.asarray(out["img"])
    # something was drawn: not all background
    assert np.abs(img - 1.0).max() > 0.1
    mask = np.asarray(out["mask"])
    assert mask.max() > 0.3 and mask.min() >= 0.0 and mask.max() <= 1.0
    assert np.asarray(out["is_vis"]).sum() > 0


def test_live_mask_excludes(rng):
    scene = make_scene(rng)
    live = np.ones((scene["means3d"].shape[0],), bool)
    live[::2] = False
    out_all = render(scene, REF)
    out_half = render(scene, REF, live=jnp.asarray(live))
    assert np.abs(np.asarray(out_all["img"]) - np.asarray(out_half["img"])).max() > 1e-3
    # radius zeroed for dead gaussians
    assert np.all(np.asarray(out_half["radius"])[~live] == 0)


def _loss_fn(settings, scene, weights):
    def f(means3d, scales, quats, opacities, rgbs, bg, m2d_off):
        out = rasterize(
            means3d,
            scales,
            quats,
            opacities,
            rgbs,
            scene["live"],
            scene["cam"],
            scene["img_shape"],
            bg,
            settings,
            m2d_off,
        )
        return (
            jnp.sum(out["img"] * weights[..., :3])
            + jnp.sum(out["depth"] * weights[..., 3])
            + jnp.sum(out["mask"] * weights[..., 4])
        )

    return f


def test_gradients_pallas_vs_oracle_autodiff(rng):
    scene = make_scene(rng, n=32)
    H, W = scene["img_shape"]
    weights = jnp.asarray(rng.normal(size=(H, W, 5)).astype(np.float32))
    n = scene["means3d"].shape[0]
    m2d_off = jnp.zeros((n, 2), jnp.float32)
    args = (
        scene["means3d"],
        scene["scales"],
        scene["quats"],
        scene["opacities"],
        scene["rgbs"],
        scene["bg"],
        m2d_off,
    )
    g_ref = fast_jit(jax.grad(_loss_fn(REF, scene, weights), argnums=tuple(range(7))))(*args)
    g_pal = fast_jit(jax.grad(_loss_fn(PAL, scene, weights), argnums=tuple(range(7))))(*args)
    names = ["means3d", "scales", "quats", "opacities", "rgbs", "bg", "mean2d_off"]
    for name, a, b in zip(names, g_ref, g_pal):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1e-3, np.abs(a).max())
        np.testing.assert_allclose(
            b, a, atol=5e-4 * scale, rtol=2e-3, err_msg=f"grad mismatch: {name}"
        )
        assert np.abs(a).max() > 0, f"zero grads for {name}?"


def test_gradients_finite_difference(rng):
    scene = make_scene(rng, n=8, img=(8, 128))
    H, W = scene["img_shape"]
    weights = jnp.asarray(rng.normal(size=(H, W, 5)).astype(np.float32))
    n = 8
    m2d_off = jnp.zeros((n, 2), jnp.float32)
    f = _loss_fn(REF, scene, weights)
    args = [
        scene["means3d"],
        scene["scales"],
        scene["quats"],
        scene["opacities"],
        scene["rgbs"],
        scene["bg"],
        m2d_off,
    ]
    grads = fast_jit(jax.grad(f, argnums=(0, 3, 4)))(*args)
    f = fast_jit(f)
    # finite differences on a few coordinates of means3d, opacity, rgbs
    for argi, g in zip((0, 3, 4), grads):
        x = np.asarray(args[argi], np.float64)
        flat_idx = [0, x.size // 2, x.size - 1]
        for fi in flat_idx:
            eps = 3e-4
            xp = x.reshape(-1).copy()
            xm = x.reshape(-1).copy()
            xp[fi] += eps
            xm[fi] -= eps
            ap = list(args)
            am = list(args)
            ap[argi] = jnp.asarray(xp.reshape(x.shape), jnp.float32)
            am[argi] = jnp.asarray(xm.reshape(x.shape), jnp.float32)
            fd = (float(f(*ap)) - float(f(*am))) / (2 * eps)
            an = float(np.asarray(g).reshape(-1)[fi])
            assert abs(fd - an) < 5e-2 * max(1.0, abs(fd)), (
                f"arg {argi} idx {fi}: fd={fd} vs analytic={an}"
            )


def test_depth_ordering(rng):
    """A nearer opaque gaussian must occlude a farther one."""
    from exavatar_release_tpu.core.camera import Camera

    H, W = 8, 128
    cam = Camera(
        R=jnp.eye(3),
        t=jnp.zeros(3),
        focal=jnp.array([100.0, 100.0]),
        princpt=jnp.array([W / 2, H / 2]),
    )
    means = jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, 4.0]])
    scales = jnp.full((2, 3), 0.05)
    quats = jnp.tile(jnp.array([1.0, 0, 0, 0]), (2, 1))
    opac = jnp.array([[0.95], [0.95]])
    rgbs = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    out = _rasterize(
        means,
        scales,
        quats,
        opac,
        rgbs,
        jnp.ones(2, bool),
        cam,
        (H, W),
        jnp.zeros(3),
        REF,
    )
    # center pixel: mostly red (near gaussian in front)
    c = np.asarray(out["img"][H // 2, W // 2 - 1])
    assert c[0] > 0.8 and c[1] < 0.2, c
    d = float(out["depth"][H // 2, W // 2 - 1])
    assert 1.8 < d < 2.4, d


def test_overflow_reported(rng):
    scene = make_scene(rng, n=128)
    tiny = RasterizeSettings(
        backend="ref", tile_h=8, tile_w=128, max_per_tile=8, chunk=8
    )
    out = render(scene, tiny)
    assert int(np.asarray(out["tile_counts"]).max()) > 8  # uncapped count reported


class TestBinningParity:
    def test_sorted_matches_scan(self, rng):
        """The pair-sort binning must reproduce the scan-compaction oracle
        exactly (same depth ordering per tile)."""
        import jax.numpy as jnp

        from exavatar_release_tpu.ops.rasterizer.binning import (
            bin_gaussians_scan,
            bin_gaussians_sorted,
        )
        from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians
        from gs_scene import make_scene

        sc = make_scene(rng, n=200, img=(64, 256))
        screen = project_gaussians(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"],
        )
        args = (screen.mean2d, screen.radius, screen.depth, screen.in_frustum,
                (64, 256), 8, 128, 128)
        a = bin_gaussians_scan(*args)
        b = bin_gaussians_sorted(*args, max_tiles_per_gaussian=64)
        np.testing.assert_array_equal(np.asarray(a.order), np.asarray(b.order))
        np.testing.assert_array_equal(
            np.asarray(a.tile_counts), np.asarray(b.tile_counts)
        )
        np.testing.assert_array_equal(
            np.asarray(a.tile_indices), np.asarray(b.tile_indices)
        )

    def test_compact_matches_scan(self, rng):
        """The compact pair-list binning (the default) must also reproduce
        the oracle exactly, and degrade by dropping the DEEPEST Gaussians'
        pairs when the budget overflows (windows stay prefixes)."""
        from exavatar_release_tpu.ops.rasterizer.binning import (
            bin_gaussians_compact,
            bin_gaussians_scan,
        )
        from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians
        from gs_scene import make_scene

        sc = make_scene(rng, n=200, img=(64, 256))
        screen = project_gaussians(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"],
        )
        args = (screen.mean2d, screen.radius, screen.depth, screen.in_frustum,
                (64, 256), 8, 128, 128)
        a = bin_gaussians_scan(*args)
        b = bin_gaussians_compact(*args, max_pairs=64 * 200)
        np.testing.assert_array_equal(np.asarray(a.order), np.asarray(b.order))
        np.testing.assert_array_equal(
            np.asarray(a.tile_counts), np.asarray(b.tile_counts)
        )
        np.testing.assert_array_equal(
            np.asarray(a.tile_indices), np.asarray(b.tile_indices)
        )

        cap = 64
        c = bin_gaussians_compact(*args, max_pairs=cap)
        cc = np.asarray(c.tile_counts)
        assert cc.sum() <= cap
        ti_full = np.asarray(a.tile_indices)
        ti_cap = np.asarray(c.tile_indices)
        for t in range(ti_full.shape[0]):
            np.testing.assert_array_equal(ti_cap[t, :cc[t]], ti_full[t, :cc[t]])

    def test_kernel_v2_matches_v1(self, rng):
        """The chunked-grid kernels (kernel_v=2) must match v1 bit-for-bit
        on live rows (dead (T, K) gradient regions are unwritten by design
        and routed to the dropped sentinel by the consumer)."""
        import jax
        import jax.numpy as jnp

        from exavatar_release_tpu.ops.rasterizer.api import (
            RasterizeSettings, rasterize,
        )
        from gs_scene import make_scene

        sc = make_scene(rng, n=150, img=(32, 128))
        bg = jnp.zeros(3)

        outs = {}
        for kv in (1, 2):
            settings = RasterizeSettings(
                max_per_tile=64, chunk=16, backend="pallas", kernel_v=kv
            )

            def loss(ms, ss, qs, os_, cs):
                r = rasterize(ms, ss, qs, os_, cs, sc["live"], sc["cam"],
                              sc["img_shape"], bg, settings)
                return (jnp.sum(r["img"] ** 2) + jnp.sum(r["mask"])
                        + jnp.sum(r["depth"])), r["img"]

            (l, img), grads = fast_jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
                sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
                sc["rgbs"],
            )
            outs[kv] = (l, img, grads)

        # v1 localizes tile coords IN-KERNEL, v2 consumes the pre-packed
        # coeffs — same math, different f32 op order (~1e-5 image noise;
        # grads additionally amplify through cancelling terms, so compare
        # scale-aware like the oracle-grad test does)
        np.testing.assert_allclose(outs[1][1], outs[2][1], atol=1e-4)
        for g1, g2 in zip(outs[1][2], outs[2][2]):
            a, b = np.asarray(g1), np.asarray(g2)
            scale = max(1e-3, np.abs(a).max())
            np.testing.assert_allclose(b, a, atol=5e-4 * scale, rtol=2e-3)

    def test_sorted_cap_drops_tail_tiles(self, rng):
        """A Gaussian spanning more tiles than the cap keeps its first
        (row-major) tiles only."""
        import jax.numpy as jnp

        from exavatar_release_tpu.ops.rasterizer.binning import bin_gaussians_sorted

        m2d = jnp.asarray([[128.0, 32.0]])
        rad = jnp.asarray([1000.0])  # covers everything
        depth = jnp.asarray([1.0])
        vis = jnp.asarray([True])
        out = bin_gaussians_sorted(
            m2d, rad, depth, vis, (64, 256), 8, 128, 16,
            max_tiles_per_gaussian=4,
        )
        counts = np.asarray(out.tile_counts)
        assert counts.sum() == 4  # capped
        assert counts[:4].sum() == 4  # row-major first tiles


class TestTileGatherVJP:
    def test_gather_backward_matches_autodiff(self, rng):
        """The scatter-free tile_gather backward must equal the autodiff
        (scatter-add) gradient of plain indexing."""
        import jax
        import jax.numpy as jnp

        from exavatar_release_tpu.ops.rasterizer.binning import (
            bin_gaussians_sorted,
            tile_gather,
        )
        from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians
        from gs_scene import make_scene

        sc = make_scene(rng, n=150, img=(64, 256))
        screen = project_gaussians(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"],
        )
        binning = bin_gaussians_sorted(
            screen.mean2d, screen.radius, screen.depth, screen.in_frustum,
            (64, 256), 8, 128, 64, max_tiles_per_gaussian=64,
        )
        vals = jnp.concatenate(
            [screen.params[binning.order], jnp.zeros((1, 8))], axis=0
        )
        w = jnp.asarray(rng.normal(size=(binning.tile_indices.shape[0],
                                         binning.tile_indices.shape[1], 8)).astype(np.float32))

        def loss_custom(v):
            return jnp.sum(tile_gather(
                v, binning.tile_indices, binning.pair_slot, binning.pair_tile,
                binning.starts, binning.pair_valid) * w)

        def loss_plain(v):
            return jnp.sum(v[binning.tile_indices] * w)

        # forwards identical
        np.testing.assert_array_equal(
            np.asarray(jax.jit(loss_custom)(vals)),
            np.asarray(jax.jit(loss_plain)(vals)),
        )
        g1 = jax.jit(jax.grad(loss_custom))(vals)
        g2 = jax.jit(jax.grad(loss_plain))(vals)
        # compare real rows; the sentinel row (constant in the pipeline)
        # deliberately gets zero cotangent from the custom backward
        np.testing.assert_allclose(
            np.asarray(g1[:-1]), np.asarray(g2[:-1]), rtol=1e-6, atol=1e-5
        )
        np.testing.assert_array_equal(np.asarray(g1[-1]), 0.0)

    def test_overflow_pairs_get_zero_grad(self, rng):
        """Pairs dropped by the max_per_tile window must not receive
        gradient through either path."""
        import jax
        import jax.numpy as jnp

        from exavatar_release_tpu.ops.rasterizer.binning import (
            bin_gaussians_sorted,
            tile_gather,
        )

        # 10 gaussians all in one tile, window K=4 -> 6 dropped
        m2d = jnp.tile(jnp.asarray([[64.0, 4.0]]), (10, 1))
        rad = jnp.full((10,), 2.0)
        depth = jnp.arange(10, dtype=jnp.float32) + 1.0
        vis = jnp.ones((10,), bool)
        b = bin_gaussians_sorted(m2d, rad, depth, vis, (8, 128), 8, 128, 4)
        vals = jnp.asarray(rng.normal(size=(11, 8)).astype(np.float32))
        g = jax.grad(lambda v: jnp.sum(tile_gather(
            v, b.tile_indices, b.pair_slot, b.pair_tile, b.starts, b.pair_valid) ** 2))(vals)
        # only the 4 nearest (ranks 0-3) + nothing else get gradient
        nz = np.abs(np.asarray(g)).sum(1) > 0
        assert nz[:4].all() and not nz[4:].any()


class TestPairMajor:
    """Ragged pair-major compositing (settings.pair_major): no (T, K)
    windows, no per-tile truncation — values must be BIT-equal to the dense
    pallas path (same fp expressions, same per-tile pair order) and grads
    equal up to scatter/summation order."""

    def test_forward_bit_equal_to_dense(self, rng):
        scene = make_scene(rng, n=300, img=(64, 256))
        den = RasterizeSettings(backend="pallas", max_per_tile=512, chunk=128)
        rag = RasterizeSettings(backend="pallas", pair_major=True, chunk=128)
        r1 = render(scene, den)
        r2 = render(scene, rag)
        for k in ("img", "depth", "mask"):
            np.testing.assert_array_equal(np.asarray(r1[k]), np.asarray(r2[k]))
        np.testing.assert_array_equal(
            np.asarray(r1["tile_counts"]), np.asarray(r2["tile_counts"])
        )

    def test_gradients_match_dense(self, rng):
        scene = make_scene(rng, n=200, img=(64, 256))
        den = RasterizeSettings(backend="pallas", max_per_tile=512, chunk=128)
        rag = RasterizeSettings(backend="pallas", pair_major=True, chunk=128)

        def make_loss(st):
            def loss(means, scales, opac, rgbs):
                out = render(scene, st, rasterize, means3d=means,
                             scales=scales, opacities=opac, rgbs=rgbs)
                return (jnp.sum(out["img"] ** 2) + jnp.sum(out["mask"])
                        + jnp.sum(out["depth"] * out["mask"]))
            return loss

        args = (scene["means3d"], scene["scales"], scene["opacities"],
                scene["rgbs"])
        g1 = fast_jit(jax.grad(make_loss(den), argnums=(0, 1, 2, 3)))(*args)
        g2 = fast_jit(jax.grad(make_loss(rag), argnums=(0, 1, 2, 3)))(*args)
        for a, b in zip(g1, g2):
            rms = float(jnp.sqrt(jnp.mean(a ** 2))) + 1e-12
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-3 * rms, rtol=1e-4
            )

    def test_no_truncation_where_dense_truncates(self, rng):
        """A tile overfilled past the dense path's max_per_tile: dense
        reports truncation and drops the deepest rows; pair-major keeps
        everything and must match a dense render with a big-enough K."""
        # chunk 128 everywhere: the ragged path 128-aligns its chunk for the
        # Mosaic block contract, and bit-equality needs identical prefix
        # splits
        scene = make_scene(rng, n=400, img=(32, 256))
        small = RasterizeSettings(backend="pallas", max_per_tile=128,
                                  chunk=128)
        big = RasterizeSettings(backend="pallas", max_per_tile=512, chunk=128)
        rag = RasterizeSettings(backend="pallas", pair_major=True, chunk=128)
        r_small = render(scene, small)
        r_big = render(scene, big)
        r_rag = render(scene, rag)
        assert int(r_small["n_truncated"]) > 0, "fixture must overfill"
        assert int(r_big["n_truncated"]) == 0
        assert int(r_rag["n_truncated"]) == 0
        np.testing.assert_array_equal(
            np.asarray(r_rag["img"]), np.asarray(r_big["img"])
        )

    def test_mean2d_offset_grad_flows(self, rng):
        """Densification needs d(loss)/d(mean2d_offset) through the ragged
        path too."""
        scene = make_scene(rng, n=64, img=(32, 256))
        rag = RasterizeSettings(backend="pallas", pair_major=True, chunk=64)

        def loss(off):
            out = render(scene, rag, rasterize, mean2d_offset=off)
            return jnp.sum(out["img"] ** 2)

        g = fast_jit(jax.grad(loss))(jnp.zeros((64, 2)))
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0

    def test_pair_budget_overflow_reported(self, rng):
        scene = make_scene(rng, n=300, img=(64, 256))
        rag = RasterizeSettings(backend="pallas", pair_major=True, chunk=64,
                                max_pairs=256)
        out = render(scene, rag)
        assert int(out["n_dropped_pairs"]) > 0


def test_dense_deep_scene_parity(rng):
    """Regression for the bf16 default-matmul-precision bug: a DENSE scene
    (hundreds of overlapping Gaussians per tile, large radii) catastrophically
    cancels in q = basis @ quad when jax's DEFAULT dot precision rounds f32
    inputs to bf16 (observed 0.60 max image error vs the sequential oracle;
    the shallow scenes above stayed inside tolerance and missed it). All
    kernel dots now pin Precision.HIGHEST."""
    scene = make_scene(rng, n=600, img=(64, 96))
    st_ref = RasterizeSettings(max_per_tile=640, tile_h=8, backend="ref")
    st_pal = RasterizeSettings(max_per_tile=640, tile_h=8, backend="pallas")

    def make_loss(st):
        def loss(means):
            out = render(scene, st, rasterize, means3d=means)
            tot = (jnp.sum(out["img"]) + jnp.sum(out["mask"])
                   + 0.1 * jnp.sum(out["depth"]))
            return tot, out
        return loss

    (_, o_ref), g_ref = fast_jit(jax.value_and_grad(
        make_loss(st_ref), has_aux=True))(scene["means3d"])
    (_, o_pal), g_pal = fast_jit(jax.value_and_grad(
        make_loss(st_pal), has_aux=True))(scene["means3d"])
    np.testing.assert_allclose(
        np.asarray(o_pal["img"]), np.asarray(o_ref["img"]), atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(o_pal["mask"]), np.asarray(o_ref["mask"]), atol=2e-3)
    scale = float(np.abs(np.asarray(g_ref)).max())
    np.testing.assert_allclose(
        np.asarray(g_pal), np.asarray(g_ref), atol=3e-3 * scale, rtol=5e-3)
