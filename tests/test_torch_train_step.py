"""One whole ``train_step`` of the PyTorch port against the JAX package's on
the CPU, from the same state (tests/torch_frame_fixture.py), backend "ref" on
both sides, the background being what ``jax.random.uniform(key, (3,))`` drew:

* the loss dict with ``total`` and the four ``raster_*`` diagnostics (rtol
  1e-3), ``itr``, ``active_sh_degree`` (from the iteration before the
  increment), the densification statistics of ``scene_aux`` (counts exact,
  sums 1e-3 of their largest value);
* both Adam moments of every parameter, each against its reference's largest
  magnitude (mu 1e-3, nu 2e-3: the gradient tolerance of
  tests/test_torch_frame_grad.py and its square);
* the updated parameters, where the gradient is more than 1e-6 of its leaf's
  largest: Adam's first update is lr g / (|g| + 1e-15), a full step of +-lr
  whatever |g| is, so an element whose gradient is rounding noise moves by lr
  in a direction that the last bit decides, in either package. Under the
  mask the updates agree within 1e-3 lr + 2 ulp.

Then, in the port alone: the loss falls over 8 steps on one frame, and the
densify and opacity-reset cadence of ``maybe_adjust_gaussians``.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.train import loop as jl
from exavatar_release_tpu.train.optim import make_optimizer as j_make_optimizer
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.train import loop as tl
from exavatar_release_tpu_torch.train.optim import make_optimizer
from torch_frame_fixture import TwinFrame, _fields, compile_once

torch.set_num_threads(2)

TOT = 1000
RADIUS = 3.0
ITR0 = 2345  # so that active_sh_degree = 2 comes from the iteration, not the fixture


@pytest.fixture(scope="module")
def twin():
    return TwinFrame()


@pytest.fixture(scope="module")
def step(twin):
    j = twin.j
    key = jax.random.PRNGKey(5)
    bg = np.array(jax.random.uniform(key, (3,)))
    j_opt = j_make_optimizer(j.trainables, j.cfg, RADIUS, TOT)
    j_state = jl.init_train_state(j.trainables, j.scene_aux, j_opt)._replace(
        itr=jnp.asarray(ITR0, jnp.int32))
    bundle = jl.ModelBundle(j.buffers, j.prior, j.statics, j.id_info, j.lpips, j.face_texture,
                            j.face_texture_mask, j.init_joint_offset)

    def j_step(state, frame, key):
        return jl.train_step.__wrapped__(state, bundle, frame, key, j_opt, j.cfg, False, False,
                                         j.settings)

    args = (j_state, j.frame_data[0], key)
    j_new, j_losses = compile_once(j_step, *args)(*args)

    tr = copy.deepcopy(twin.t_trainables)
    before = {k: p.detach().clone() for k, p in tr.named_parameters()}
    opt = make_optimizer(tr, twin.t_cfg, RADIUS, TOT)
    state = tl.init_train_state(tr, twin.t_scene_aux, opt)._replace(itr=ITR0)
    new, losses = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg, False,
                                settings=twin.t_settings, bg=torch.from_numpy(bg))
    # the step's gradients, from its first moment (mu = (1 - b1) g from zero)
    grads = {k: m / (1.0 - opt.b1) for k, m in new.opt_state.mu.items()}
    want = convert.train_state_from_jax(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(j_new)], twin.t_cfg, device="cpu")
    return dict(new=new, losses=losses, want=want, j_losses=j_losses, before=before,
                grads=grads, opt=opt)


def test_loss_dict(step):
    got, want = step["losses"], step["j_losses"]
    assert set(got) == set(want) and len(got) == 27
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-3, atol=1e-9, err_msg=k)
    for k in ("raster_dropped", "raster_dropped_pairs", "raster_truncated",
              "raster_exchange_overflow"):
        assert got[k].dtype == torch.float32 and float(got[k]) == float(want[k])


def test_itr_sh_degree_and_statistics(step):
    new, want = step["new"], step["want"]
    assert new.itr == want.itr == ITR0 + 1
    assert new.opt_state.count == want.opt_state.count == 1
    a, w = new.scene_aux, want.scene_aux
    assert float(a.active_sh_degree) == float(w.active_sh_degree) == 2.0
    assert torch.equal(a.live, w.live) and torch.equal(a.track_cnt, w.track_cnt)
    assert float(a.track_cnt.sum()) > 0
    np.testing.assert_allclose(a.radius_max.numpy(), w.radius_max.numpy(), atol=1e-3)
    np.testing.assert_allclose(a.xyz_grad_accum.numpy(), w.xyz_grad_accum.numpy(),
                               atol=1e-3 * float(w.xyz_grad_accum.max()))
    # rows that are dead or off screen accumulate nothing
    assert not a.track_cnt[~a.live].any()


def test_moments(step):
    new, want = step["new"].opt_state, step["want"].opt_state
    assert set(new.mu) == set(want.mu) and len(new.mu) == 79
    for k in new.mu:
        for got, ref, tol in ((new.mu[k], want.mu[k], 1e-3), (new.nu[k], want.nu[k], 2e-3)):
            scale = max(float(ref.abs().max()), 1e-30)
            assert float((got - ref).abs().max()) <= tol * scale, k


def test_parameters_where_the_gradient_is_not_noise(step):
    got = dict(step["new"].trainables.named_parameters())
    want = dict(step["want"].trainables.named_parameters())
    lrs = step["opt"].learning_rates(0)
    compared = 0
    for k, g in step["grads"].items():
        gmax = float(g.abs().max())
        mask = g.abs() > 1e-6 * gmax if gmax > 0 else torch.zeros_like(g, dtype=torch.bool)
        lr = lrs[step["opt"].labels[k]]
        ulp = float(np.spacing(np.float32(want[k].detach().abs().max())))
        diff = (got[k].detach() - want[k].detach()).abs()[mask]
        if diff.numel():
            assert float(diff.max()) <= 1e-3 * lr + 2 * ulp, k
        compared += int(mask.sum())
        # and every compared element moved by about one learning rate
        moved = (got[k].detach() - step["before"][k]).abs()[mask]
        if diff.numel() and lr > 0:
            assert float(moved.max()) <= 1.01 * lr + 2 * ulp, k
    total = sum(g.numel() for g in step["grads"].values())
    assert compared > 0.5 * total, (compared, total)


@pytest.fixture(scope="module")
def port_state(twin):
    """A fresh state of the port from the fixture's untouched initial
    weights (tests/avatar_fixture.py, the state tests/test_train.py trains
    from): from the heads that torch_frame_fixture brings into a trained
    avatar's range, a first Adam step of +-lr on every weight overshoots."""
    j = twin.j
    tr = convert.trainables_from_jax(_fields(j.scene_state.params), _fields(j.human_params),
                                     _fields(j.param_frames), twin.t_cfg, device="cpu")
    opt = make_optimizer(tr, twin.t_cfg, RADIUS, TOT)
    return tl.init_train_state(tr, twin.t_scene_aux, opt), opt


def test_loss_falls_over_eight_steps(twin, port_state):
    state, opt = port_state
    state = copy.deepcopy(state)
    g = torch.Generator().manual_seed(0)
    bg = torch.rand(3, generator=g)
    totals = []
    for _ in range(8):
        state, losses = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg,
                                      True, settings=twin.t_settings, bg=bg)
        totals.append(float(losses["total"]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
    assert state.itr == 8 and state.opt_state.count == 8
    # without ``bg`` the step draws one from the generator
    _, l1 = tl.train_step(copy.deepcopy(state), twin.t_bundle, twin.t_frame(1), opt, twin.t_cfg,
                          True, settings=twin.t_settings,
                          generator=torch.Generator().manual_seed(3))
    _, l2 = tl.train_step(copy.deepcopy(state), twin.t_bundle, twin.t_frame(1), opt, twin.t_cfg,
                          True, settings=twin.t_settings,
                          generator=torch.Generator().manual_seed(4))
    assert float(l1["rgb_human_rand_bg"]) != float(l2["rgb_human_rand_bg"])


def test_densify_cadence(twin, port_state):
    state, _ = port_state
    cfg = twin.t_cfg
    C = state.trainables.scene.mean.shape[0]
    # statistics above the threshold, so that densify fires, and moments to zero
    aux = dataclasses.replace(state.scene_aux, xyz_grad_accum=torch.ones(C),
                              track_cnt=torch.ones(C))
    seeded = copy.deepcopy(state._replace(scene_aux=aux))
    for m in (seeded.opt_state.mu, seeded.opt_state.nu):
        for k in m:
            m[k].fill_(1.0)
    gen = torch.Generator().manual_seed(0)
    for itr in (601, 500, 15000, 15100):  # off the interval, at the start, at and past the end
        _, stats = tl.maybe_adjust_gaussians(copy.deepcopy(seeded), itr, cfg, generator=gen)
        assert stats is None, itr
    _, stats = tl.maybe_adjust_gaussians(copy.deepcopy(seeded), 600, cfg, True, generator=gen)
    assert stats is None  # nothing under fit_pose_to_test
    live_before = seeded.scene_aux.live.clone()
    new, stats = tl.maybe_adjust_gaussians(seeded, 600, cfg, generator=gen)
    assert stats is not None and int(stats["n_cloned"]) + int(stats["n_split"]) > 0
    assert int(stats["n_live"]) == int(new.scene_aux.live.sum())
    assert float(new.scene_aux.track_cnt.sum()) == 0.0
    born = new.scene_aux.live & ~live_before
    assert bool(born.any())
    for k in ("scene.mean", "scene.opacity", "scene.feature_rest"):
        assert not new.opt_state.mu[k][born].any() and not new.opt_state.nu[k][born].any()
    assert bool((new.opt_state.mu["human.triplane"] == 1).all())
    assert new.opt_state.count == seeded.opt_state.count


def test_opacity_reset_cadence(twin, port_state):
    state, _ = port_state
    state = copy.deepcopy(state)
    state.opt_state.mu["scene.opacity"].fill_(1.0)
    state.opt_state.mu["scene.mean"].fill_(1.0)
    new, _ = tl.maybe_adjust_gaussians(state, 3000, twin.t_cfg,
                                       generator=torch.Generator().manual_seed(0))
    op = torch.sigmoid(new.trainables.scene.opacity.detach())[new.scene_aux.live]
    assert bool((op <= 0.0101).all())
    assert not new.opt_state.mu["scene.opacity"].any()
    # itr 0 is a multiple of the interval, but no reset happens there
    fresh = copy.deepcopy(port_state[0])
    same, _ = tl.maybe_adjust_gaussians(fresh, 0, twin.t_cfg)
    assert torch.equal(same.trainables.scene.opacity, port_state[0].trainables.scene.opacity)
