"""The rasterizer capacity governor: a train from absurd scales grows its
binning budgets until no pair is dropped, within bounds, and switches to the
pair-major path under sustained truncation.

Each budget the governor grows to is a new static setting of train_step, so
the train runs one fast-compiled program per step (tests/fast_compile.py)."""
import jax
import pytest

from exavatar_release_tpu.train.loop import init_train_state
from exavatar_release_tpu.train.optim import make_optimizer
from avatar_fixture import AvatarSetup, train_step_program


@pytest.fixture(scope="module")
def setup():
    return AvatarSetup(H=40, W=48, capacity=256, n_scene=120)


@pytest.fixture(scope="module")
def bundle(setup):
    return setup.bundle()


class TestRasterCapacityGovernor:
    """Auto-growth of rasterizer binning capacities (round-3 verdict item 8:
    warmup from absurd random-init scales must reach zero dropped pairs
    without manual knobs)."""

    def test_grows_until_zero_drops_with_absurd_scales(self, setup, bundle):
        import dataclasses

        from exavatar_release_tpu.train.loop import RasterCapacityGovernor

        s = setup
        # absurd init: bias the scale head to emit ~0.6 m Gaussians (the
        # warmup clamp caps the HUMAN at 1 mm, but the SCENE Gaussians in
        # this fixture are already meter-scale from the sparse-cloud KNN
        # init, so binning overflows the default budgets)
        tiny = dataclasses.replace(
            s.settings, max_per_tile=32, pairs_per_gaussian=1
        )
        opt = make_optimizer(s.trainables, s.cfg, 3.0, tot_itr=100)
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        gov = RasterCapacityGovernor(tiny, patience=1)
        key = jax.random.PRNGKey(0)
        dropped_first = None
        for i in range(8):
            key, sub = jax.random.split(key)
            state, losses = train_step_program(
                state, bundle, s.frame_data[0], sub, opt, s.cfg,
                is_warmup=True, settings=gov.settings,
            )
            d_pairs = float(losses["raster_dropped_pairs"])
            d_trunc = float(losses["raster_truncated"])
            if dropped_first is None:
                dropped_first = d_pairs + d_trunc
            if d_pairs == 0 and d_trunc == 0:
                break
            gov.update(d_pairs, d_trunc)
        assert dropped_first > 0, "fixture must start in the overflow regime"
        assert d_pairs == 0 and d_trunc == 0, (
            f"governor failed to reach zero drops: pairs={d_pairs} "
            f"trunc={d_trunc} settings={gov.settings}"
        )
        assert gov.settings.pairs_per_gaussian > 1

    def test_growth_is_bounded(self):
        from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings
        from exavatar_release_tpu.train.loop import RasterCapacityGovernor

        gov = RasterCapacityGovernor(
            RasterizeSettings(max_per_tile=8192, pairs_per_gaussian=8192),
            patience=1, max_per_tile_ceiling=16384,
        )
        for _ in range(20):
            gov.update(1e9, 1e9)
        assert gov.settings.max_per_tile <= 16384
        assert gov.settings.pairs_per_gaussian <= (1 << 24) // 1024

    def test_sustained_truncation_switches_to_pair_major(self):
        """Dense-window growth past the threshold flips the render to the
        ragged pair-major path (where truncation does not exist) instead of
        doubling K into empty-slot HBM traffic."""
        from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings
        from exavatar_release_tpu.train.loop import RasterCapacityGovernor

        gov = RasterCapacityGovernor(
            RasterizeSettings(max_per_tile=1024), patience=1,
            pair_major_threshold=4096,
        )
        while not gov.settings.pair_major:
            gov.update(0.0, 1e6)
        # the switch replaced a K-doubling, not accompanied one
        assert gov.settings.max_per_tile <= 4096
        # with the ragged path active truncation is structurally zero, so
        # the settings stay put (continued fake truncation would mean the
        # render ignored pair_major — the sharded fallback — where dense
        # growth must resume, which the elif covers)
        before = gov.settings
        gov.update(0.0, 0.0)
        assert gov.settings == before
