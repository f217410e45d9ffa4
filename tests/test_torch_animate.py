"""The animate render path end to end: the port's ``render_motion`` against
the JAX package's ``human_forward`` -> ``rasterize`` on the same avatar and
poses, dense and pair-major, on the CPU.

Dense: the JAX side runs its ``backend="ref"`` oracle and the port its plain
dense composite, which evaluate the same expressions: 2e-4 (img) and
1e-4 (mask, depth) cover the human_forward differences (float32 matmul
order, up to ~5e-7 in positions, up to 7.4e-5 in a pixel's q) seen through
the rasterizer. It runs under the seam of tests/torch_xla_math.py (XLA's
transcendentals for the port's) and, as ``dense-torch_libm``, on the port's
own libm, at the same bounds. Observed on an AVX-512 host, either way: img
2.2e-4 on one pixel of 49,152 and below 7.3e-5 elsewhere, mask 5.7e-5,
depth 8.9e-5. That pixel is a flipped threshold: one Gaussian's q there is
-5.5412655 on the JAX side and -5.5412593 on the port's, on either side of
ln(1/255) = -5.5412636, so alpha >= 1/255 admits it on one side only. A
pixel may exceed the bounds only where such a flip can happen: where the
JAX side's q of one of its rows lies within ``Q_FLIP`` of ln(1/255) or of
its log-opacity, or its transmittance test T(1 - alpha) within a relative
``T_FLIP`` of 1e-4 (``_near_threshold``); the bounds themselves stay.

Pair-major: the JAX side runs the ragged Pallas kernel in interpret mode
(log-space transmittance), hence the kernel tolerances of
tests/test_goldens.py, 2e-3 (img, mask) and 5e-3 (depth).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.ops.rasterizer import RasterizeSettings as JSettings
from exavatar_release_tpu.ops.rasterizer import rasterize as j_rasterize
from exavatar_release_tpu.ops.rasterizer.preprocess import project_gaussians as j_project
from exavatar_release_tpu_torch.apps.animate import render_motion
from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings as TSettings
from torch_frame_fixture import fast_jit
from torch_port_fixture import TwinAvatar
from torch_xla_math import xla_transcendentals

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
# (mode, under the seam): dense under it and on the port's own libm;
# pair-major, at the kernel tolerances, on the port's own libm as before
CASES = {"dense": ("dense", True), "pair_major": ("pair_major", False),
         "dense-torch_libm": ("dense", False)}
# a flipped threshold: the largest |q_jax - q_port| over this scene's
# pixel-Gaussian pairs with q > -7 is 7.4e-5; T's relative difference
Q_FLIP = 1e-4
T_FLIP = 1e-3
LN_ALPHA_MIN = float(np.log(np.float32(1.0 / 255.0)))


# the JAX render and projection as one program each: run op by op the
# render costs ~100 compiles
_j_rasterize = fast_jit(j_rasterize, static_argnums=(7, 9))
_j_project = fast_jit(j_project, static_argnums=(7,))


@pytest.fixture(scope="module")
def twin():
    return TwinAvatar(seed=1, n_poses=2)


@pytest.fixture(scope="module")
def j_frames(twin):
    """Per mode, the JAX side's frames; and per pose its screen-space rows
    (params, in_frustum, depth) for the threshold check."""
    j_cam, _ = twin.cameras(H, W, FOCAL)
    assets = [twin.j_human_forward(i, j_cam).assets_refined for i in range(len(twin.poses))]
    frames = {
        mode: [_to_numpy(_j_rasterize(a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live,
                                      j_cam, (H, W), jnp.ones(3), j_set))
               for a in assets]
        for mode, (j_set, _, _) in MODES.items()
    }
    screens = []
    for a in assets:
        s = _j_project(a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, j_cam, (H, W))
        screens.append((np.asarray(s.params), np.asarray(s.in_frustum), np.asarray(s.depth)))
    return frames, screens


def _to_numpy(out):
    return {k: np.asarray(out[k]) for k in ("img", "mask", "depth", "tile_counts",
                                            "n_dropped")}


def _near_threshold(screen, x: int, y: int) -> bool:
    """Whether a row at pixel (x, y), composited front to back on the JAX
    side in float32 by the reference's rules, has q within ``Q_FLIP`` of
    ln(1/255) or of its log-opacity, or a transmittance test within a
    relative ``T_FLIP`` of 1e-4."""
    params, vis, depth = screen
    rows = params[np.argsort(np.where(vis, depth, np.inf), kind="stable")[: int(vis.sum())]]
    A, B, C, gx, gy, log_op = (rows[:, i].astype(np.float32) for i in range(6))
    dx, dy = np.float32(x) - gx, np.float32(y) - gy
    q = log_op - np.float32(0.5) * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy)
    if (np.abs(q - LN_ALPHA_MIN) <= Q_FLIP).any() or (np.abs(q - log_op) <= Q_FLIP).any():
        return True
    alpha_un = np.exp(q)
    alpha = np.where((q <= log_op) & (alpha_un >= np.float32(1 / 255)),
                     np.minimum(alpha_un, np.float32(0.99)), np.float32(0))
    T = np.float32(1)
    for a in alpha:
        test_T = T * (np.float32(1) - a)
        if abs(test_T - 1e-4) <= T_FLIP * 1e-4:
            return True
        if test_T < 1e-4:
            return False
        T = test_T
    return False


@pytest.mark.parametrize("case", list(CASES))
def test_render_motion_matches_jax(twin, j_frames, case):
    mode, seam = CASES[case]
    _, t_set, tol = MODES[mode]
    frames_j, screens = j_frames
    _, t_cam = twin.cameras(H, W, FOCAL)
    n = len(twin.poses)
    with xla_transcendentals(seam):
        frames = render_motion(
            twin.t_human, twin.t_buffers, twin.t_prior, twin.t_id,
            [twin.t_pose(i) for i in range(n)], [t_cam] * n, twin.t_cfg, t_set, (H, W),
        )
    assert len(frames) == n
    for want, got, screen in zip(frames_j[mode], frames, screens):
        assert int(want["n_dropped"]) == 0 and int(got["n_dropped"]) == 0
        assert 0.02 < float(got["mask"].mean()) < 0.98  # the avatar is in view
        if mode != "dense":
            for k in tol:
                np.testing.assert_allclose(got[k].numpy(), want[k], atol=tol[k],
                                           err_msg=f"{case} {k}")
        else:
            over = np.zeros((H, W), bool)
            for k in tol:
                g = got[k].numpy()
                assert g.shape == want[k].shape and np.isfinite(g).all(), k
                d = np.abs(g - want[k])
                over |= (d.max(-1) if d.ndim == 3 else d) > tol[k]
            ys, xs = np.nonzero(over)
            unexplained = [(x, y) for x, y in zip(xs, ys) if not _near_threshold(screen, x, y)]
            assert not unexplained, f"{case}: pixels (x, y) over the bounds {unexplained}"
        np.testing.assert_array_equal(got["tile_counts"].numpy(), want["tile_counts"])
