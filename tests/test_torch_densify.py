"""Densification of the PyTorch port against the JAX package on the CPU, on
the same numpy scene: ``track_stats`` (1e-6), ``_alloc_slots`` (integers
exact), ``densify_and_prune`` in both prune modes and on a full scene that
drops requests (the split children's noise is what ``jax.random.normal`` drew
from the same key; live mask, ``reset_mask`` and the four counts exact,
parameters 1e-6), ``reset_opacity`` (1e-6). ``densify_and_prune`` and
``reset_opacity``, whose chains run through exp, log and sigmoid, are held
under the seam of tests/torch_xla_math.py (XLA's transcendentals for the
port's) and, as the ``torch_libm`` cases, on the port's own libm, at the
same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar import scene as jsc
from exavatar_release_tpu.avatar.config import AvatarConfig as JCfg
from exavatar_release_tpu_torch.avatar import scene as tsc
from exavatar_release_tpu_torch.avatar.config import AvatarConfig as TCfg
from exavatar_release_tpu_torch.avatar.convert import scene_from_jax
from torch_port_fixture import fast_jit
from torch_xla_math import seam_cases, xla_transcendentals

torch.set_num_threads(2)

C = 96
PARAMS = ("mean", "scale", "rotation", "feature_dc", "feature_rest", "opacity")
AUX = ("live", "radius_max", "xyz_grad_accum", "track_cnt", "active_sh_degree",
       "cam_dist_trans", "cam_dist_radius")


# the JAX functions as one program each: run op by op they cost ~200 compiles
_J = {"track_stats": fast_jit(jsc.track_stats, static_argnames=("img_shape",)),
      "alloc_slots": fast_jit(jsc._alloc_slots),
      "densify_and_prune": fast_jit(jsc.densify_and_prune, static_argnums=(2, 3)),
      "reset_opacity": fast_jit(jsc.reset_opacity)}


def _scene(seed, n_live, hot_share=0.5):
    """A numpy scene of capacity C with ``n_live`` live rows: half of the
    live rows above the densify threshold, scales on both sides of the
    clone/split border (0.01 * radius 3 = 0.03), some opacities below
    opacity_min, some radii above the screen-size limit."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    live = np.zeros(C, bool)
    live[rng.permutation(C)[:n_live]] = True
    params = dict(
        mean=f(C, 3),
        scale=np.log(np.where(rng.uniform(size=(C, 1)) < 0.5, rng.uniform(0.005, 0.028, (C, 3)),
                              rng.uniform(0.02, 0.4, (C, 3)))).astype(np.float32),
        rotation=f(C, 6), feature_dc=f(C, 1, 3), feature_rest=f(C, 15, 3),
        opacity=rng.uniform(-7, 3, (C, 1)).astype(np.float32))
    cnt = rng.integers(0, 4, C).astype(np.float32)
    aux = dict(
        live=live, radius_max=rng.uniform(0, 30, C).astype(np.float32),
        xyz_grad_accum=(cnt * np.where(rng.uniform(size=C) < hot_share, 5e-4, 5e-5))
        .astype(np.float32),
        track_cnt=cnt, active_sh_degree=np.float32(1.0),
        cam_dist_trans=np.zeros(3, np.float32), cam_dist_radius=np.float32(3.0))
    return params, aux


def _j_state(params, aux):
    return jsc.SceneState(jsc.SceneParams(**{k: jnp.asarray(v) for k, v in params.items()}),
                          jsc.SceneAux(**{k: jnp.asarray(v) for k, v in aux.items()}))


def _t_state(params, aux):
    return tsc.SceneState(*scene_from_jax(params, aux, device="cpu"))


def _assert_state(t_state, j_state, atol=1e-6):
    for k in PARAMS:
        np.testing.assert_allclose(getattr(t_state.params, k).detach().numpy(),
                                   np.asarray(getattr(j_state.params, k)), atol=atol, rtol=1e-6,
                                   err_msg=k)
    for k in AUX:
        got, want = getattr(t_state.aux, k).numpy(), np.asarray(getattr(j_state.aux, k))
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("img_shape", [None, (1080, 1920)], ids=["pixel_units", "ndc_units"])
def test_track_stats(img_shape):
    params, aux = _scene(0, 60)
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1e-4, (C, 2)).astype(np.float32)
    vis = rng.uniform(size=C) < 0.7
    radius = rng.uniform(0, 40, C).astype(np.float32)
    want = _J["track_stats"](_j_state(params, aux), jnp.asarray(g), jnp.asarray(vis),
                           jnp.asarray(radius), img_shape=img_shape)
    got = tsc.track_stats(_t_state(params, aux), torch.from_numpy(g), torch.from_numpy(vis),
                          torch.from_numpy(radius), img_shape=img_shape)
    _assert_state(got, want)
    # only visible live rows count
    np.testing.assert_array_equal((got.aux.track_cnt.numpy() - aux["track_cnt"]) > 0,
                                  vis & aux["live"])
    if img_shape is not None:
        grew = got.aux.xyz_grad_accum.numpy() - aux["xyz_grad_accum"]
        np.testing.assert_allclose(
            grew, np.where(vis & aux["live"], np.hypot(g[:, 0] * 960, g[:, 1] * 540), 0),
            rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("n_free,n_want", [(10, 4), (4, 10), (0, 3), (7, 0), (96, 96)])
def test_alloc_slots_integers(n_free, n_want):
    rng = np.random.default_rng(n_free * 100 + n_want)
    free = np.zeros(C, bool)
    free[rng.permutation(C)[:n_free]] = True
    want = np.zeros(3 * C, bool)
    want[rng.permutation(3 * C)[:n_want]] = True
    j_slots, j_drop = _J["alloc_slots"](jnp.asarray(free), jnp.asarray(want))
    t_slots, t_drop = tsc._alloc_slots(torch.from_numpy(free), torch.from_numpy(want))
    assert t_slots.dtype == torch.int32
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    assert int(t_drop) == int(j_drop) == max(0, n_want - n_free)


CASES = {"no_screen_prune": (60, False), "screen_prune": (60, True), "full_scene": (92, False)}


@pytest.mark.parametrize("case, seam", seam_cases(list(CASES)))
def test_densify_and_prune(case, seam):
    n_live, screen = CASES[case]
    params, aux = _scene(3, n_live, hot_share=0.8)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (2, C, 3)))
    want = _J["densify_and_prune"](_j_state(params, aux), key, JCfg(), screen)
    with xla_transcendentals(seam):
        got = tsc.densify_and_prune(_t_state(params, aux), TCfg(), screen,
                                    eps=torch.from_numpy(eps))
    for k in ("n_cloned", "n_split", "n_pruned", "n_dropped"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_array_equal(got.reset_mask.numpy(), np.asarray(want.reset_mask))
    _assert_state(got.state, want.state)
    assert int(got.n_cloned) > 0 and int(got.n_split) > 0 and int(got.n_pruned) > 0
    assert (int(got.n_dropped) > 0) == (case == "full_scene")
    # every granted request became a live row that was free or freed before
    granted = int(got.n_cloned) + 2 * int(got.n_split) - int(got.n_dropped)
    kept = aux["live"] & ~(np.asarray(want.reset_mask) & aux["live"])
    assert int(got.state.aux.live.sum()) == int(kept.sum()) + granted
    assert not got.state.aux.track_cnt.any() and not got.state.aux.radius_max.any()


def test_densify_draws_its_noise_from_the_generator():
    params, aux = _scene(3, 60, hot_share=0.8)
    runs = []
    for seed in (5, 5, 6):
        g = torch.Generator().manual_seed(seed)
        runs.append(tsc.densify_and_prune(_t_state(params, aux), TCfg(), False, generator=g)
                    .state.params.mean.detach())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_reset_opacity(seam):
    params, aux = _scene(4, 60)
    want, j_mask = _J["reset_opacity"](_j_state(params, aux))
    state = _t_state(params, aux)
    with xla_transcendentals(seam):
        got, t_mask = tsc.reset_opacity(state)
    _assert_state(got, want)
    assert got.params is state.params  # written in place
    assert bool(t_mask.all()) and t_mask.shape == (C,) and bool(np.asarray(j_mask).all())
    assert float(torch.sigmoid(got.params.opacity.detach()).max()) <= 0.0101
