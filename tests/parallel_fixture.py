"""Shared pieces of the multi-device tests (tests/test_parallel_*.py) on the
virtual 8-device CPU mesh: the meshes, the render settings, and the renders
they compare, each run as one fast-compiled program (tests/fast_compile.py)."""
import jax
import pytest

from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings, rasterize
from exavatar_release_tpu.parallel import (
    make_mesh,
    rasterize_gaussian_sharded,
    rasterize_sharded,
)
from fast_compile import fast_jit

SETTINGS = RasterizeSettings(backend="ref", max_per_tile=256)

# static: img_shape, settings (and the sharded renders' mesh, axis, cap)
render = fast_jit(rasterize, static_argnums=(7, 9))
render_sharded = fast_jit(rasterize_sharded, static_argnums=(7, 9, 10, 11))
render_gaussian_sharded = fast_jit(
    rasterize_gaussian_sharded, static_argnums=(7, 9, 10, 11),
    static_argnames=("cap",),
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh (EXAVATAR_TEST_TPU run?)")
    return make_mesh((4,), ("tile",))


@pytest.fixture(scope="module")
def data_mesh():
    return make_mesh((2,), ("data",))
