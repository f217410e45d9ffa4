"""The animate render path end to end: the port's ``render_motion`` against
the JAX package's ``human_forward`` -> ``rasterize`` on the same avatar and
poses, dense and pair-major, on the CPU.

Dense: the JAX side runs its ``backend="ref"`` oracle and the port its plain
dense composite, which evaluate the same expressions: 2e-4 (img) and
1e-4 (mask, depth) cover the
human_forward differences (float32, ~1e-5 in positions) seen through the
rasterizer (observed: img 7e-5, mask 8e-6, depth 2e-5). Pair-major: the JAX side runs the ragged Pallas kernel in
interpret mode (log-space transmittance), hence the kernel tolerances of
tests/test_goldens.py, 2e-3 (img, mask) and 5e-3 (depth).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.ops.rasterizer import RasterizeSettings as JSettings
from exavatar_release_tpu.ops.rasterizer import rasterize as j_rasterize
from exavatar_release_tpu_torch.apps.animate import render_motion
from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings as TSettings
from torch_frame_fixture import fast_jit
from torch_port_fixture import TwinAvatar

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W, FOCAL = 64, 256, 60.0
# a small pair budget keeps the interpret-mode ragged kernel's grid short
COMMON = dict(tile_h=32, tile_w=128, pairs_per_gaussian=4)
MODES = {
    "dense": (JSettings(backend="ref", max_per_tile=2048, **COMMON),
              TSettings(max_per_tile=2048, **COMMON),
              {"img": 2e-4, "mask": 1e-4, "depth": 1e-4}),
    "pair_major": (JSettings(pair_major=True, interpret=True, **COMMON),
                   TSettings(pair_major=True, **COMMON),
                   {"img": 2e-3, "mask": 2e-3, "depth": 5e-3}),
}


# the JAX render as one program: run op by op it costs ~100 compiles
_j_rasterize = fast_jit(j_rasterize, static_argnums=(7, 9))


@pytest.fixture(scope="module")
def twin():
    return TwinAvatar(seed=1, n_poses=2)


@pytest.fixture(scope="module")
def j_assets(twin):
    j_cam, _ = twin.cameras(H, W, FOCAL)
    return [twin.j_human_forward(i, j_cam).assets_refined for i in range(len(twin.poses))]


@pytest.mark.parametrize("mode", list(MODES))
def test_render_motion_matches_jax(twin, j_assets, mode):
    j_set, t_set, tol = MODES[mode]
    j_cam, t_cam = twin.cameras(H, W, FOCAL)
    n = len(twin.poses)
    frames = render_motion(
        twin.t_human, twin.t_buffers, twin.t_prior, twin.t_id,
        [twin.t_pose(i) for i in range(n)], [t_cam] * n, twin.t_cfg, t_set, (H, W),
    )
    assert len(frames) == n
    for a, got in zip(j_assets, frames):
        want = _j_rasterize(a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live,
                           j_cam, (H, W), jnp.ones(3), j_set)
        assert int(want["n_dropped"]) == 0 and int(got["n_dropped"]) == 0
        assert 0.02 < float(got["mask"].mean()) < 0.98  # the avatar is in view
        for k in tol:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol[k],
                                       err_msg=f"{mode} {k}")
        np.testing.assert_array_equal(got["tile_counts"].numpy(), np.asarray(want["tile_counts"]))
