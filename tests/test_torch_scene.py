"""Scene Gaussians of the PyTorch port against the JAX package on the CPU:
spherical harmonics, the k=4 KNN scale statistic, the point-cloud
initialisation and the decoding to render-ready assets, and the per-frame
6D pose store, on identical numpy inputs. Tolerance 1e-5 (float32 on both sides; sums in another order).
``scene_assets`` and the pose store, whose chains run through sigmoid, exp,
sin, cos and atan2, are held under the seam of tests/torch_xla_math.py
(XLA's transcendentals for the port's) and, as the ``torch_libm`` cases, on
the port's own libm, at the same bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar import scene as jsc
from exavatar_release_tpu.avatar.config import AvatarConfig as JCfg
from exavatar_release_tpu.avatar.param_dict import init_param_frames as j_init_param_frames
from exavatar_release_tpu.core import sh as jsh
from exavatar_release_tpu.ops.knn import mean_knn_dist_sq as j_mean_knn
from exavatar_release_tpu_torch.avatar import scene as tsc
from exavatar_release_tpu_torch.avatar.config import AvatarConfig as TCfg
from exavatar_release_tpu_torch.avatar.convert import scene_from_jax
from exavatar_release_tpu_torch.avatar.gaussians import concat_assets, detach_assets
from exavatar_release_tpu_torch.avatar.param_dict import init_param_frames as t_init_param_frames
from exavatar_release_tpu_torch.core import sh as tsh
from exavatar_release_tpu_torch.ops.knn import mean_knn_dist_sq as t_mean_knn
from torch_frame_fixture import fast_jit
from torch_xla_math import seam_cases, xla_transcendentals

torch.set_num_threads(2)
ATOL = 1e-5


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    n = 200
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 2, n), rng.uniform(3, 5, n)],
                   1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = fast_jit(jsc.init_from_point_cloud, static_argnums=(4,))(
        jnp.asarray(xyz), jnp.asarray(rgb), jnp.zeros(3), jnp.asarray(3.0), 256)
    return xyz, rgb, state


def test_sh_basis_and_band_mask():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(tsh.sh_basis(torch.from_numpy(d)).numpy(),
                               np.asarray(jsh.sh_basis(jnp.asarray(d))), atol=ATOL)
    for deg in (0, 1, 2.0, 3, 4):
        for bands in (1, 9, 16, 25):
            np.testing.assert_array_equal(
                tsh.band_mask(deg, bands).numpy(), np.asarray(jsh.band_mask(deg, bands)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_dynamic(deg):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sh = rng.normal(size=(40, 3, 16)).astype(np.float32)
    want = jsh.eval_sh_dynamic(jnp.asarray(float(deg)), jnp.asarray(sh), jnp.asarray(d))
    got = tsh.eval_sh_dynamic(torch.tensor(float(deg)), torch.from_numpy(sh),
                              torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), atol=ATOL)
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.from_numpy(rgb))).numpy(), rgb,
                               atol=ATOL)


def test_mean_knn_dist_sq(cloud):
    xyz, _, _ = cloud
    want = np.asarray(j_mean_knn(jnp.asarray(xyz), k=4))
    got = t_mean_knn(torch.from_numpy(xyz), k=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)
    # self excluded: the statistic is the mean over the 3 nearest OTHER points
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, np.sort(d2, 1)[:, 1:4].mean(1), rtol=1e-3, atol=ATOL)
    # chunking does not change it
    np.testing.assert_allclose(t_mean_knn(torch.from_numpy(xyz), k=4, chunk=64).numpy(), got,
                               atol=1e-6)


def test_init_from_point_cloud(cloud):
    xyz, rgb, want = cloud
    got = tsc.init_from_point_cloud(torch.from_numpy(xyz), torch.from_numpy(rgb), torch.zeros(3),
                                    3.0, 256)
    assert got.capacity == 256 and int(got.num_live) == 200
    for k, w in _fields(want.params).items():
        g = getattr(got.params, k).detach().numpy()
        assert g.shape == w.shape, k
        # the log-scale comes from ||q||^2 - 2 q.r + ||r||^2, whose cancellation
        # leaves ~1e-5 relative noise in either package's distance
        np.testing.assert_allclose(g, w, atol=1e-4 if k == "scale" else ATOL, err_msg=k)
    for k, w in _fields(want.aux).items():
        g = getattr(got.aux, k).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=k)
    # dead rows hold identity 6D rotations, not zeros
    np.testing.assert_array_equal(got.params.rotation.detach().numpy()[200:],
                                  np.tile([1.0, 0, 0, 0, 1, 0], (56, 1)).astype(np.float32))
    with pytest.raises(ValueError):
        tsc.init_from_point_cloud(torch.from_numpy(xyz), torch.from_numpy(rgb), torch.zeros(3),
                                  3.0, 100)


@pytest.mark.parametrize("deg, seam", seam_cases({"0.0": 0.0, "2.0": 2.0}))
def test_scene_assets(cloud, deg, seam):
    _, _, state = cloud
    rng = np.random.default_rng(3)
    p = state.params.replace(
        feature_rest=jnp.asarray(rng.normal(0, 0.1, state.params.feature_rest.shape)
                                 .astype(np.float32)),
        rotation=jnp.asarray(rng.normal(0, 1, state.params.rotation.shape).astype(np.float32)),
    )
    aux = state.aux.replace(active_sh_degree=jnp.asarray(deg))
    R = np.asarray(jax.random.orthogonal(jax.random.PRNGKey(0), 3), np.float32)
    t = np.asarray([0.1, -0.2, 0.5], np.float32)
    want = fast_jit(jsc.scene_assets)(jsc.SceneState(p, aux), jnp.asarray(R), jnp.asarray(t))
    tp, ta = scene_from_jax(_fields(p), _fields(aux), device="cpu")
    with xla_transcendentals(seam):  # sigmoid, exp
        got = tsc.scene_assets(tsc.SceneState(tp, ta), torch.from_numpy(R), torch.from_numpy(t))
    for k in ("mean_3d", "opacity", "scale", "rotation", "rgb"):
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)), atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
    if deg:  # the view direction counts above degree 0
        flat = tsc.scene_assets(
            tsc.SceneState(tp, dataclasses.replace(ta, active_sh_degree=torch.tensor(0.0))),
            torch.from_numpy(R), torch.from_numpy(t))
        assert float((flat.rgb - got.rgb).abs().max()) > 1e-3


def test_dead_zero_row_keeps_backward_finite():
    """A dead row at the camera center has a degenerate view direction."""
    state = tsc.init_empty(8, device="cpu")
    out = tsc.scene_assets(state, torch.eye(3), torch.zeros(3))
    out.rgb.sum().backward()
    for p in state.params.parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all())
    want = jsc.init_empty(8)
    for k, w in _fields(want.params).items():
        assert tuple(getattr(state.params, k).shape) == w.shape, k


def test_set_sh_degree_and_asset_helpers(cloud):
    xyz, rgb, _ = cloud
    st = tsc.init_from_point_cloud(torch.from_numpy(xyz), torch.from_numpy(rgb), torch.zeros(3),
                                   3.0, 256)
    for itr in (0, 999, 2500, 10 ** 6):
        want = jsc.set_sh_degree(jsc.init_empty(4), itr, JCfg()).aux.active_sh_degree
        got = tsc.set_sh_degree(st, itr, TCfg()).aux.active_sh_degree
        assert float(got) == float(want)
    a = tsc.scene_assets(st, torch.eye(3), torch.zeros(3))
    both = concat_assets(detach_assets(a), a)
    assert both.mean_3d.shape == (512, 3) and both.live.shape == (512,)
    assert not detach_assets(a).rgb.requires_grad and both.rgb.requires_grad
    assert torch.equal(both.rgb[:256], a.rgb) and torch.equal(both.rgb[256:], a.rgb)


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_param_frames_store_and_lookup(seam):
    rng = np.random.default_rng(7)
    frames = [
        {"root_pose": rng.normal(0, 1, 3), "body_pose": rng.normal(0, 0.3, (21, 3)),
         "jaw_pose": rng.normal(0, 0.1, 3), "leye_pose": np.zeros(3), "reye_pose": np.zeros(3),
         "lhand_pose": rng.normal(0, 0.2, (15, 3)), "rhand_pose": rng.normal(0, 0.2, 45),
         "expr": rng.normal(0, 0.5, 4), "trans": rng.normal(0, 1, 3)}
        for _ in range(3)
    ]
    want = fast_jit(lambda: j_init_param_frames(frames))()  # the poses enter as constants
    with xla_transcendentals(seam):  # sin, cos, atan2 of the 6D rotations
        got = t_init_param_frames(frames, device="cpu")
    assert got.num_frames == want.num_frames == 3
    assert len(list(got.parameters())) == 9
    for k, w in _fields(want).items():
        g = getattr(got, k).detach().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=k)
    jp, tp = fast_jit(lambda pf: pf.lookup(1))(want), got.lookup(1)
    for k, w in _fields(jp).items():
        np.testing.assert_allclose(getattr(tp, k).detach().numpy(), w, atol=ATOL, err_msg=k)
    # a lookup is differentiable back to its own row only
    tp.body_pose.sum().backward()
    assert got.body_pose.grad[1].abs().sum() > 0 and not got.body_pose.grad[[0, 2]].any()
