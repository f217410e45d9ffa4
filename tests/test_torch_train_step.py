"""The differentiable frame, the train step and what it is built on, in the
PyTorch port against the JAX package on the CPU, from one synthetic avatar
carried across as numpy (tests/torch_frame_fixture.py, built once for the
file), backend "ref" on both sides.

**``forward_frame``**: ``build_statics`` against the JAX tables; test mode
(every render key, atol 1e-4) and train mode (every loss of the dict, rtol
1e-3) during warm-up and when fitting poses to test frames (there with a
face window and an LPIPS crop smaller than the frame).

**One ``train_step``**, the background being what
``jax.random.uniform(key, (3,))`` drew:

* the loss dict with ``total`` and the four ``raster_*`` diagnostics (rtol
  1e-3), ``itr``, ``active_sh_degree`` (from the iteration before the
  increment), the densification statistics of ``scene_aux`` (counts exact,
  sums 1e-3 of their largest value);
* both Adam moments of every parameter, each against its reference's largest
  magnitude (mu 1e-3, nu 2e-3: the gradient tolerance below and its
  square);
* the updated parameters, where the gradient is more than 1e-6 of its leaf's
  largest: Adam's first update is lr g / (|g| + 1e-15), a full step of +-lr
  whatever |g| is, so an element whose gradient is rounding noise moves by lr
  in a direction that the last bit decides, in either package. Under the
  mask the updates agree within 1e-3 lr + 2 ulp.

Then, in the port alone: the loss falls over 8 steps on one frame, and the
densify and opacity-reset cadence of ``maybe_adjust_gaussians``.

**One ``parallel.dp_train_step`` over frames 0 and 1** (both local to the
one rank of a gloo world of one process): its mean gradient, read from the
first moment, against the mean of the JAX step's ``value_and_grad`` on each
frame (the step's program called again on frame 1), each leaf within 1e-3
of its largest value; its densification statistics against JAX's
``track_stats`` of the two frames' summed screen-space gradients.

**The losses and gradients after warm-up**, against the ``jax.value_and_grad``
that the JAX ``train_step`` above takes of its loss (captured while it is
traced), on the same state and background: every loss of the dict (rtol
1e-3), and the gradient of every leaf of the trainables and of the (C, 2)
screen-space offset, each scaled by its reference's largest magnitude (atol
1e-3; the worst leaf measured when this was written: 1.5e-5,
human.triplane_face), from the port's ``loss_and_grads``, which leaves the
parameters untouched.

**The rasterizer's capacity governor and the scene's capacity growth**: the
cases of tests/test_train.py for the JAX class (bounded growth, the switch to
pair-major, training from absurdly small capacities healed within 8 steps),
every branch of ``update`` against the JAX class on the same counter
sequences (the settings both end with are equal, field by field), and
``grow_scene_capacity`` with a further step and a densify pass at the new
capacity.

**The optimizer** against the JAX package's (optax):

* schedules at their end points and breaks: 1e-6 relative (both evaluate in
  float32);
* the group label of every one of the 79 parameters against
  ``group_label_tree`` (the JAX tree has 12 zero-size placeholder leaves
  besides, for layers without a GroupNorm);
* five Adam steps from the same parameters on identical gradients made with
  numpy, some of them rounding noise (1e-12), which Adam with eps 1e-15
  turns into full steps of +-lr in both packages alike: moments rtol 1e-5,
  parameters within 5 (1e-6 lr + one float32 ulp of the parameter);
* ``fit_pose_to_test`` freezes scene and human;
* moment surgery (``zero_scene_moments``, ``zero_opacity_moments``) against
  the JAX functions, then one more step: the step count is untouched and
  the restarted rows go on with the global bias correction.

**Checkpoints**, both ways: the port's static leaf list against
``jax.tree_util.tree_flatten_with_path`` of the JAX ``TrainState``; a round
trip inside the port (every leaf bit for bit); a snapshot written by the JAX
package loaded into the port; one written by the port loaded into the JAX
package with a JAX template. Every comparison is exact: a checkpoint moves
bytes.
"""
import copy
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar.model import forward_frame as j_forward_frame
from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings as JSettings
from exavatar_release_tpu.train import checkpoint as jck
from exavatar_release_tpu.train import loop as jl
from exavatar_release_tpu.train import optim as jo
from exavatar_release_tpu.train.loop import RasterCapacityGovernor as JGovernor
from exavatar_release_tpu.train.optim import make_optimizer as j_make_optimizer
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.avatar.convert import human_params_from_jax
from exavatar_release_tpu_torch.avatar.model import forward_frame as t_forward_frame
from exavatar_release_tpu_torch.avatar.model import total_loss as t_total_loss
from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings
from exavatar_release_tpu_torch.train import checkpoint as tck
from exavatar_release_tpu_torch.train import loop as tl
from exavatar_release_tpu_torch.train import optim as to
from exavatar_release_tpu_torch.train.loop import TrainState, loss_and_grads
from exavatar_release_tpu_torch.train.optim import make_optimizer
from torch_frame_fixture import TwinFrame, _fields, compile_once

torch.set_num_threads(2)

TOT = 1000
RADIUS = 3.0
ITR0 = 2345  # so that active_sh_degree = 2 comes from the iteration, not the fixture


@pytest.fixture(scope="module")
def twin():
    return TwinFrame()


# --- forward_frame: test mode, and train mode during warm-up ------------------

TEST_KEYS = (
    "scene_img", "human_img", "scene_human_img", "human_img_refined",
    "scene_human_img_refined", "scene_human_img_composed",
    "scene_human_img_refined_composed", "human_face_img", "human_face_img_refined",
)
POSE_LOSS_KEYS = {
    "rgb_human", "ssim_human", "lpips_human", "rgb_face", "rgb_human_rand_bg",
    "rgb_human_refined", "ssim_human_refined", "lpips_human_refined", "rgb_face_refined",
    "rgb_human_refined_rand_bg",
}


def _j_forward(tw, **kw):
    j = tw.j
    cfg = kw.pop("cfg", j.cfg)
    fn = compile_once(lambda tr: j_forward_frame(
        tr, j.scene_aux, j.buffers, j.prior, j.statics, j.id_info, j.lpips, j.face_texture,
        j.face_texture_mask, j.init_joint_offset, j.frame_data[0], tw.j_bg, cfg,
        settings=j.settings, **kw), j.trainables)
    return fn(j.trainables)


def _t_forward(tw, **kw):
    b = tw.t_bundle
    with torch.no_grad():
        return t_forward_frame(
            tw.t_trainables, tw.t_scene_aux, b.buffers, b.prior, b.statics, b.id_info, b.lpips,
            b.face_texture, b.face_texture_mask, b.init_joint_offset, tw.t_frame(0), tw.t_bg,
            tw.t_cfg, settings=tw.t_settings, **kw)


def test_statics_match(twin):
    """``build_statics`` of the port against the JAX package's tables, which
    cross as numpy through ``statics_from_numpy``."""
    from exavatar_release_tpu_torch.avatar.convert import statics_from_numpy

    want = statics_from_numpy({k: np.asarray(v) for k, v in twin.j.statics._asdict().items()},
                              device="cpu")
    got = twin.t_bundle.statics
    for k in want._fields:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.int64:
            assert torch.equal(g, w), k
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, err_msg=k)
    assert len(got.upper_arm_idx) > 1 and len(got.lower_arm_idx) > 1


def test_test_mode_renders(twin):
    want = _j_forward(twin, is_warmup=False, mode="test")
    got = _t_forward(twin, is_warmup=False, mode="test")
    assert set(got.renders) == set(want.renders) and got.losses == {}
    H, W = twin.j.H, twin.j.W
    for k in TEST_KEYS + ("human_mask", "human_mask_refined", "face_render",
                          "face_render_refined"):
        g, w = got.renders[k].numpy(), np.asarray(want.renders[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=k)
    for k in TEST_KEYS:
        assert got.renders[k].shape[:2] == (H, W), k
    # the human covers part of the frame and the face mesh part of the human
    assert 0.02 < float((got.renders["human_mask"] > 0.5).float().mean()) < 0.9
    fr = got.renders["face_render"]
    assert bool((fr == -1).all(0).any()) and bool((fr[:3] != -1).any())
    np.testing.assert_array_equal(got.scene_radius.numpy(), np.asarray(want.scene_radius))
    np.testing.assert_array_equal(got.scene_is_vis.numpy(), np.asarray(want.scene_is_vis))


def test_train_mode_losses_in_warmup(twin):
    kw = dict(is_warmup=True, mode="train")
    want = _j_forward(twin, **kw)
    got = _t_forward(twin, **kw)
    assert set(got.losses) == set(want.losses) and len(got.losses) == 22
    for k, w in want.losses.items():
        np.testing.assert_allclose(float(got.losses[k]), float(w), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    assert np.isfinite(float(t_total_loss(got.losses)))
    # the warm-up clamp is on: the human's Gaussians are 1 mm
    assert float(got.losses["lap_scale"]) < 1e-9
    for f in ("raster_dropped", "raster_dropped_pairs", "raster_truncated"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f


def test_fit_pose_to_test_in_a_face_window(twin):
    """``fit_pose_to_test`` keeps the image losses only. With a face window
    and an LPIPS crop smaller than the frame: the face patch lands at its
    origin over a -1 background, as the JAX package's dynamic_update_slice
    puts it, and LPIPS sees the crop around the bbox."""
    j = twin.j
    jcfg = dataclasses.replace(j.cfg, face_render_h=24, face_render_w=32, lpips_crop_h=32,
                               lpips_crop_w=40)
    tcfg = dataclasses.replace(twin.t_cfg, face_render_h=24, face_render_w=32, lpips_crop_h=32,
                               lpips_crop_w=40)
    want = _j_forward(twin, cfg=jcfg, is_warmup=True, mode="train", fit_pose_to_test=True)
    b = twin.t_bundle
    with torch.no_grad():
        got = t_forward_frame(
            twin.t_trainables, twin.t_scene_aux, b.buffers, b.prior, b.statics, b.id_info,
            b.lpips, b.face_texture, b.face_texture_mask, b.init_joint_offset, twin.t_frame(0),
            twin.t_bg, tcfg, is_warmup=True, mode="train", fit_pose_to_test=True,
            settings=twin.t_settings)
    g, w = got.renders["face_render"].numpy(), np.asarray(want.renders["face_render"])
    assert (w != -1).any() and (w == -1).all(0).mean() > 0.5
    np.testing.assert_allclose(g, w, atol=1e-4)
    assert set(got.losses) == set(want.losses) == POSE_LOSS_KEYS
    for k, w in want.losses.items():
        np.testing.assert_allclose(float(got.losses[k]), float(w), rtol=1e-3, atol=1e-9,
                                   err_msg=k)


# --- one train step ------------------------------------------------------------


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

    # the JAX step's own ``jax.value_and_grad`` of its loss, captured while
    # the step is traced, comes out of the program beside the step's results
    captured, value_and_grad = [], jax.value_and_grad

    def capture(fn, *a, **kw):
        inner = value_and_grad(fn, *a, **kw)

        def call(*args):
            captured.append(inner(*args))
            return captured[-1]
        return call

    def j_step(state, frame, key):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "value_and_grad", capture)
            new, losses = jl.train_step.__wrapped__(state, bundle, frame, key, j_opt, j.cfg,
                                                    False, False, j.settings)
        assert len(captured) == 1, len(captured)
        (tot, out), (g_tr, g_m2d) = captured[0]
        return new, losses, (tot, out.losses, g_tr, g_m2d, out.scene_is_vis, out.scene_radius)

    args = (j_state, j.frame_data[0], key)
    j_step_c = compile_once(j_step, *args)
    j_new, j_losses, j_vag = j_step_c(*args)

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
                grads=grads, opt=opt, bg=bg, j_vag=j_vag, j_step=j_step_c, j_state=j_state)


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

# --- after warm-up: the losses and every gradient ------------------------------


@pytest.fixture(scope="module")
def after_warmup(twin, step):
    """JAX's ``value_and_grad`` of the train-step loss after warm-up (the one
    its ``train_step`` took above) and the port's ``loss_and_grads`` on the same
    state and background."""
    tw = twin
    tot, losses, g_tr, g_off = step["j_vag"][:4]
    want = {"scene." + k: v for k, v in _fields(g_tr.scene).items()}
    want.update({"human." + k: v.numpy()
                 for k, v in human_params_from_jax(_fields(g_tr.human)).items()})
    want.update({"frames." + k: v for k, v in _fields(g_tr.frames).items()})
    before = {k: v.detach().clone() for k, v in tw.t_trainables.named_parameters()}
    got = loss_and_grads(tw.t_trainables, tw.t_scene_aux, tw.t_bundle, tw.t_frame(0),
                         torch.from_numpy(step["bg"]), tw.t_cfg, is_warmup=False,
                         settings=tw.t_settings)
    return tw, float(tot), losses, want, np.asarray(g_off), got, before


def test_losses_after_warmup(after_warmup):
    _, tot, losses, _, _, (t_tot, out, _, _), _ = after_warmup
    assert set(out.losses) == set(losses) and len(losses) == 22
    for k, w in losses.items():
        np.testing.assert_allclose(float(out.losses[k]), float(w), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(t_tot), tot, rtol=1e-4)
    assert not t_tot.requires_grad
    assert all(not v.requires_grad for v in out.renders.values())


def test_gradient_of_every_leaf(after_warmup):
    tw, _, _, want, _, (_, _, grads, _), _ = after_warmup
    assert set(grads) == set(want) == {k for k, _ in tw.t_trainables.named_parameters()}
    errs = {}
    for k, w in want.items():
        g = grads[k].numpy()
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        errs[k] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-12)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    # the loss reaches every part: scene, human heads, identity, per-frame poses
    for k in ("scene.mean", "scene.opacity", "scene.feature_rest", "human.triplane",
              "human.shape_param", "human.joint_offset", "frames.body_pose", "frames.trans",
              "human.rgb_offset_net.linears.0.weight"):
        assert float(np.abs(want[k]).max()) > 0 and float(grads[k].abs().max()) > 0, k
    # only frame 0 was rendered
    assert not grads["frames.body_pose"][1].any()


def test_mean2d_offset_gradient(after_warmup):
    tw, _, _, _, g_off, (_, out, _, g2d), _ = after_warmup
    assert tuple(g2d.shape) == g_off.shape == (tw.j.scene_state.capacity, 2)
    assert float(np.abs(g_off).max()) > 0
    err = float(np.abs(g2d.numpy() - g_off).max()) / float(np.abs(g_off).max())
    assert err <= 1e-3, err
    # dead rows and rows off screen get none
    live = np.asarray(tw.j.scene_aux.live)
    assert not g2d.numpy()[~live].any()
    assert not g2d.numpy()[~out.scene_is_vis.numpy()].any()


def test_step_leaves_parameters_untouched(after_warmup):
    tw, *_, before = after_warmup
    for k, p in tw.t_trainables.named_parameters():
        assert p.grad is None, k
        assert torch.equal(p.detach(), before[k]), k


# --- one data-parallel step over two frames ----------------------------------


def _j_grads(g_tr):
    """JAX gradients of the trainables under the port's leaf names."""
    want = {"scene." + k: v for k, v in _fields(g_tr.scene).items()}
    want.update({"human." + k: v.numpy()
                 for k, v in human_params_from_jax(_fields(g_tr.human)).items()})
    want.update({"frames." + k: v for k, v in _fields(g_tr.frames).items()})
    return want


@pytest.fixture(scope="module")
def two_frames(twin, step):
    """``parallel.dp_train_step`` of the port over frames 0 and 1, both local
    to the one rank of a gloo world of one process (the sum over the frames,
    1/B with B = 2, the update), against the JAX step's own
    ``jax.value_and_grad`` of each frame's loss (the program of ``step``,
    called again on frame 1 with another key), from the same state."""
    import torch.distributed as dist

    from exavatar_release_tpu.avatar import scene as jsc
    from exavatar_release_tpu_torch.parallel import (
        dp_train_step, init_distributed, make_host_mesh)

    j = twin.j
    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))  # frame 0's is step's
    vags = [step["j_vag"], step["j_step"](step["j_state"], j.frame_data[1], keys[1])[2]]
    bgs = np.stack([np.array(jax.random.uniform(k, (3,))) for k in keys])
    # JAX's densification statistics of the two frames, as its data-parallel
    # step gathers them: gradients summed, visibility OR-ed, radius maxed
    img_shape = tuple(int(x) for x in j.frame_data[0].img.shape[1:])
    j_aux = jsc.track_stats(jsc.SceneState(j.trainables.scene, j.scene_aux),
                            vags[0][3] + vags[1][3], vags[0][4] | vags[1][4],
                            jnp.maximum(vags[0][5], vags[1][5]), img_shape=img_shape).aux
    g0, g1 = _j_grads(vags[0][2]), _j_grads(vags[1][2])
    want = dict(total=(float(vags[0][0]) + float(vags[1][0])) / 2,
                grads={k: (g0[k] + g1[k]) / 2 for k in g0}, aux=_fields(j_aux))

    tr = copy.deepcopy(twin.t_trainables)
    opt = make_optimizer(tr, twin.t_cfg, RADIUS, TOT)
    state = tl.init_train_state(tr, copy.deepcopy(twin.t_scene_aux), opt)._replace(itr=ITR0)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        new, losses = dp_train_step(state, twin.t_bundle, [twin.t_frame(0), twin.t_frame(1)],
                                    torch.from_numpy(bgs), opt, twin.t_cfg, make_host_mesh(d_tile=1),
                                    "data", is_warmup=False, settings=twin.t_settings)
    finally:
        dist.destroy_process_group()
    return new, losses, opt, want


def test_dp_train_step_over_two_frames_against_jax(two_frames):
    """The step's mean gradient (from its first moment, mu = (1 - b1) g from
    zero) against the mean of JAX's two ``value_and_grad``s, each leaf within
    1e-3 of its largest value (test_gradient_of_every_leaf's bound): a wrong
    1/B or a frame summed twice is off by a factor. Its densification
    statistics against JAX's ``track_stats`` of the two frames' summed
    screen-space gradients (test_itr_sh_degree_and_statistics's bounds)."""
    new, losses, opt, want = two_frames
    np.testing.assert_allclose(float(losses["total"]), want["total"], rtol=1e-4)
    errs = {}
    for k, w in want["grads"].items():
        g = (new.opt_state.mu[k] / (1.0 - opt.b1)).numpy()
        assert g.shape == w.shape, k
        errs[k] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-12)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    # both frames' pose rows are reached, each by its own frame
    assert float(new.opt_state.mu["frames.body_pose"][0].abs().max()) > 0
    assert float(new.opt_state.mu["frames.body_pose"][1].abs().max()) > 0
    a, w = new.scene_aux, want["aux"]
    np.testing.assert_array_equal(a.track_cnt.numpy(), w["track_cnt"])
    assert float(a.track_cnt.max()) >= 1
    np.testing.assert_allclose(a.radius_max.numpy(), w["radius_max"], atol=1e-3)
    np.testing.assert_allclose(a.xyz_grad_accum.numpy(), w["xyz_grad_accum"],
                               atol=1e-3 * float(w["xyz_grad_accum"].max()))


# --- the capacity governor ---------------------------------------------------

SHARED = ("max_per_tile", "pair_major", "max_pairs", "pairs_per_gaussian")


def test_growth_is_bounded():
    gov = tl.RasterCapacityGovernor(
        RasterizeSettings(max_per_tile=8192, pairs_per_gaussian=8192, backend="ref"),
        patience=1, max_per_tile_ceiling=16384)
    for _ in range(20):
        gov.update(1e9, 1e9)
    assert gov.settings.max_per_tile == 16384
    assert gov.settings.pairs_per_gaussian == (1 << 24) // 1024
    assert not gov.settings.pair_major  # backend "ref" has no pair-major path


def test_sustained_truncation_switches_to_pair_major():
    gov = tl.RasterCapacityGovernor(RasterizeSettings(max_per_tile=1024), patience=1,
                                    pair_major_threshold=4096)
    grown = []
    while not gov.settings.pair_major:
        gov.update(0.0, 1e6)
        grown.append(gov.settings.max_per_tile)
    # 1024 -> 2048 -> 4096, then the switch instead of a further doubling
    assert grown == [2048, 4096, 4096]
    before = gov.settings
    gov.update(0.0, 0.0)
    assert gov.settings == before


def _sequence(seed, n=40):
    rng = np.random.default_rng(seed)
    on = lambda p: (rng.uniform(size=n) < p) * rng.integers(1, 1000, n).astype(float)
    return list(zip(on(0.6), on(0.6), on(0.5)))


@pytest.mark.parametrize("case", ["defaults", "explicit_budget", "ref_backend", "exchange_cap"])
def test_update_against_the_jax_class(case):
    kw = dict(defaults=dict(max_per_tile=256, pairs_per_gaussian=2),
              explicit_budget=dict(max_per_tile=512, max_pairs=1 << 20),
              ref_backend=dict(max_per_tile=2048, backend="ref"),
              exchange_cap=dict(max_per_tile=1024))[case]
    gkw = dict(patience=2, pair_major_threshold=2048, max_pairs_ceiling=1 << 22)
    if case == "exchange_cap":
        gkw.update(exchange_cap_floor=3000, patience=1)
    j_kw = dict(kw)
    if j_kw.get("backend") != "ref":
        j_kw["backend"] = "pallas"
    logs = ([], [])
    jg = JGovernor(JSettings(**j_kw), log=logs[0].append, **gkw)
    tg = tl.RasterCapacityGovernor(RasterizeSettings(**kw), log=logs[1].append, **gkw)
    for i, (pairs, trunc, xovf) in enumerate(_sequence(len(case))):
        js = jg.update(pairs, trunc, xovf)
        ts = tg.update(pairs, trunc, xovf)
        for f in SHARED:
            assert getattr(ts, f) == getattr(js, f), (i, f)
        # both packages keep the exchange's capacity in the settings
        assert ts.exchange_cap == js.exchange_cap, i
    assert logs[0] == logs[1] and logs[0]
    if case == "exchange_cap":
        assert ts.exchange_cap >= 6000  # grown from the caller's floor, never below it


@pytest.fixture(scope="module")
def port(twin):
    """The port's train state from the fixture's untouched initial weights,
    whose scene Gaussians are meter-sized (a sparse cloud's KNN scales)."""
    j = twin.j
    tr = convert.trainables_from_jax(_fields(j.scene_state.params), _fields(j.human_params),
                                     _fields(j.param_frames), twin.t_cfg, device="cpu")
    opt = make_optimizer(tr, twin.t_cfg, 3.0, 100)
    return twin, tl.init_train_state(tr, twin.t_scene_aux, opt), opt


def test_grows_until_zero_drops_with_absurd_capacities(port):
    twin, state, opt = port
    state = copy.deepcopy(state)
    tiny = dataclasses.replace(twin.t_settings, max_per_tile=32, pairs_per_gaussian=1)
    gov = tl.RasterCapacityGovernor(tiny, patience=1)
    gen = torch.Generator().manual_seed(0)
    first = None
    for _ in range(8):
        state, losses = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg,
                                      True, settings=gov.settings, generator=gen)
        d_pairs, d_trunc = float(losses["raster_dropped_pairs"]), float(losses["raster_truncated"])
        assert float(losses["raster_dropped"]) == d_pairs + d_trunc
        first = d_pairs + d_trunc if first is None else first
        if d_pairs == 0 and d_trunc == 0:
            break
        gov.update(d_pairs, d_trunc)
    assert first > 0, "the fixture must start in the overflow regime"
    assert d_pairs == 0 and d_trunc == 0, (d_pairs, d_trunc, gov.settings)
    assert gov.settings.pairs_per_gaussian > 1


def test_grow_scene_capacity_and_a_further_step(port):
    twin, state, opt = port
    state = copy.deepcopy(state)
    C = state.trainables.scene.mean.shape[0]
    state, _ = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg, True,
                             settings=twin.t_settings, bg=torch.full((3,), 0.5))
    old = {k: p.detach().clone() for k, p in state.trainables.named_parameters()}
    old_mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    assert tl.grow_scene_capacity(state, C) is state
    with pytest.raises(ValueError):
        tl.grow_scene_capacity(state, C - 1)
    grown = tl.grow_scene_capacity(state, 2 * C)
    sc = grown.trainables.scene
    names = {k for k, _ in grown.trainables.named_parameters()}
    assert names == set(old) and len(names) == 79
    for k, p in grown.trainables.named_parameters():
        if k.startswith("scene."):
            assert p.shape[0] == 2 * C and isinstance(p, torch.nn.Parameter) and p.requires_grad
            assert torch.equal(p[:C].detach(), old[k])
            for m in (grown.opt_state.mu[k], grown.opt_state.nu[k]):
                assert m.shape == p.shape and not m[C:].any()
            assert torch.equal(grown.opt_state.mu[k][:C], old_mu[k])
        else:
            assert torch.equal(p.detach(), old[k]) and grown.opt_state.mu[k] is not None
    # new rows: dead, zero, identity 6D rotations
    assert not grown.scene_aux.live[C:].any() and grown.scene_aux.live.shape == (2 * C,)
    assert grown.scene_aux.live.dtype == torch.bool
    assert not sc.mean[C:].any() and not sc.opacity[C:].any()
    assert torch.equal(sc.rotation[C:].detach(),
                       torch.tensor([1.0, 0, 0, 0, 1, 0]).repeat(C, 1))
    assert grown.opt_state.count == 1 and grown.itr == 1
    # one more step and a densify pass at the new capacity
    grown, losses = tl.train_step(grown, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg, False,
                                  settings=twin.t_settings, bg=torch.full((3,), 0.5))
    assert np.isfinite(float(losses["total"])) and grown.opt_state.count == 2
    assert not grown.opt_state.mu["scene.mean"][C:].any()  # dead rows get no gradient
    cfg = twin.t_cfg
    aux = dataclasses.replace(grown.scene_aux, xyz_grad_accum=torch.ones(2 * C),
                              track_cnt=torch.ones(2 * C))
    grown, stats = tl.maybe_adjust_gaussians(
        grown._replace(scene_aux=aux), cfg.densify_start_itr + cfg.densify_interval, cfg,
        generator=torch.Generator().manual_seed(1))
    assert stats is not None and int(stats["n_live"]) > 0 and int(stats["n_dropped"]) == 0
    assert int(stats["n_live"]) == int(grown.scene_aux.live.sum()) > 200
    assert all(bool(torch.isfinite(p).all()) for p in grown.trainables.parameters())

# --- the optimizer -----------------------------------------------------------


def _leaf_names(tree):
    """Dotted key paths of a JAX tree's leaves."""
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    dotted = lambda path: ".".join(str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
                                   for k in path)
    return [dotted(p) for p, _ in paths]


STEPS = [0, 1, 99, 100, 749, 750, 751, 949, 950, 951, 1000, 29999, 30000, 40000]


@pytest.mark.parametrize("fit_pose_to_test", [False, True], ids=["train", "fit_pose"])
def test_schedules(twin, fit_pose_to_test):
    want = jo.make_schedules(twin.j.cfg, RADIUS, TOT, fit_pose_to_test)
    got = to.make_schedules(twin.t_cfg, RADIUS, TOT, fit_pose_to_test)
    assert set(got) == set(want) == set(to.GROUPS)
    for g in to.GROUPS:
        for step in STEPS:
            np.testing.assert_allclose(got[g](step), float(want[g](jnp.asarray(step))),
                                       rtol=1e-6, atol=0, err_msg=f"{g} at {step}")
    if fit_pose_to_test:
        assert got["human"](0) == 0.0 and got["scene_mean"](0) == 0.0
        assert got["smplx"](0) == pytest.approx(1e-3)


def test_expon_and_staged_endpoints():
    s = to.expon_lr_schedule(1e-2, 1e-4, max_steps=100)
    for step, lr in ((0, 1e-2), (50, 1e-3), (100, 1e-4), (500, 1e-4)):
        assert s(step) == pytest.approx(lr, rel=1e-5)
    d = to.expon_lr_schedule(1e-2, 1e-4, lr_delay_steps=10, lr_delay_mult=0.01, max_steps=100)
    j = jo.expon_lr_schedule(1e-2, 1e-4, lr_delay_steps=10, lr_delay_mult=0.01, max_steps=100)
    for step in (0, 3, 10, 60):
        assert d(step) == pytest.approx(float(j(step)), rel=1e-6)
    st = to.staged_decay_schedule(1e-3, 1000)
    assert [st(x) for x in (100, 750, 751, 950, 951)] == pytest.approx(
        [1e-3, 1e-3, 1e-4, 1e-4, 1e-5])


def test_group_label_of_every_leaf(twin):
    labels = jo.group_label_tree(twin.j.trainables)
    j_names = _leaf_names(twin.j.trainables)
    j_labels = jax.tree_util.tree_leaves(labels)
    assert len(j_names) == len(j_labels) == 91
    by_torch_name = {t: j_labels[i] for i, (_, t, _) in enumerate(convert._TRAINABLE_LEAVES)
                     if t is not None}
    assert [j for j, _, _ in convert._TRAINABLE_LEAVES] == j_names
    names = [k for k, _ in twin.t_trainables.named_parameters()]
    assert len(names) == 79 and set(names) == set(by_torch_name)
    for k in names:
        assert to.group_label(k) == by_torch_name[k], k
    opt = to.make_optimizer(twin.t_trainables, twin.t_cfg, RADIUS, TOT)
    assert opt.labels == by_torch_name


def _numpy_grads(tree, seed):
    """One gradient per JAX leaf: mostly O(1e-3) values, a tenth rounding
    noise (+-1e-12), a tenth exact zeros."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for x in leaves:
        g = rng.normal(0, 1e-3, x.shape)
        u = rng.uniform(size=x.shape)
        g = np.where(u < 0.1, np.sign(g) * 1e-12, np.where(u < 0.2, 0.0, g))
        out.append(g.astype(np.float32))
    return out, treedef


def _as_torch(leaves):
    names = [f"trainables.{j}" for j, _, _ in convert._TRAINABLE_LEAVES]
    return convert._tree_from_numpy(dict(zip(names, leaves)), "trainables.", "cpu")


def _assert_tree(got, want_tree, rtol, atol_of=lambda w: 0.0):
    want = _as_torch([np.asarray(x) for x in jax.tree_util.tree_leaves(want_tree)])
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=rtol,
                                   atol=atol_of(w.numpy()), err_msg=k)


@pytest.fixture(scope="module")
def five_steps(twin):
    """Both optimizers after five steps on the same gradients."""
    import copy

    j_tr = twin.j.trainables
    j_opt = jo.make_optimizer(j_tr, twin.j.cfg, RADIUS, TOT)
    j_state = j_opt.init(j_tr)

    @jax.jit
    def j_step(tr, st, g):
        import optax
        upd, st = j_opt.update(g, st, tr)
        return optax.apply_updates(tr, upd), st

    t_tr = copy.deepcopy(twin.t_trainables)
    t_opt = to.make_optimizer(t_tr, twin.t_cfg, RADIUS, TOT)
    t_state = t_opt.init(t_tr)
    for i in range(5):
        leaves, treedef = _numpy_grads(j_tr, seed=i)
        j_tr, j_state = j_step(j_tr, j_state,
                               jax.tree_util.tree_unflatten(treedef, list(map(jnp.asarray, leaves))))
        t_state = t_opt.update(_as_torch(leaves), t_state, t_tr)
    return j_opt, j_tr, j_state, t_opt, t_tr, t_state


def test_five_adam_steps_on_identical_gradients(twin, five_steps):
    j_opt, j_tr, j_state, t_opt, t_tr, t_state = five_steps
    assert t_state.count == int(j_state[0].count) == int(j_state[1].count) == 5
    _assert_tree(t_state.mu, j_state[0].mu, rtol=1e-5, atol_of=lambda w: 1e-12)
    _assert_tree(t_state.nu, j_state[0].nu, rtol=1e-5, atol_of=lambda w: 1e-18)
    lrs = t_opt.learning_rates(0)
    got = dict(t_tr.named_parameters())
    want = _as_torch([np.asarray(x) for x in jax.tree_util.tree_leaves(j_tr)])
    moved = 0
    for k, w in want.items():
        lr = lrs[t_opt.labels[k]]
        tol = 5 * (1e-6 * lr + np.spacing(np.abs(w.numpy()).max().astype(np.float32)))
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
        moved += int(not torch.equal(got[k].detach(), dict(twin.t_trainables.named_parameters())[k]))
    assert moved == 79


def test_fit_pose_to_test_freezes_scene_and_human(twin):
    import copy

    tr = copy.deepcopy(twin.t_trainables)
    opt = to.make_optimizer(tr, twin.t_cfg, RADIUS, TOT, fit_pose_to_test=True)
    state = opt.init(tr)
    leaves, _ = _numpy_grads(twin.j.trainables, seed=9)
    opt.update(_as_torch(leaves), state, tr)
    before = dict(twin.t_trainables.named_parameters())
    for k, p in tr.named_parameters():
        same = torch.equal(p.detach(), before[k].detach())
        assert same == (not k.startswith("frames.")), k
    assert state.count == 1 and float(state.mu["scene.mean"].abs().max()) > 0


def test_moment_surgery_keeps_the_step_count(twin, five_steps):
    import copy

    j_opt, j_tr, j_state, t_opt, t_tr, t_state = five_steps
    t_tr, t_state = copy.deepcopy(t_tr), copy.deepcopy(t_state)
    C = t_tr.scene.mean.shape[0]
    mask = np.random.default_rng(2).uniform(size=C) < 0.3
    j_state = jo.zero_scene_moments(j_state, jnp.asarray(mask), j_opt, j_tr)
    j_state = jo.zero_opacity_moments(j_state, j_opt, j_tr)
    t_state = to.zero_opacity_moments(to.zero_scene_moments(t_state, torch.from_numpy(mask)))
    assert t_state.count == 5
    for k in ("scene.mean", "scene.rotation", "scene.feature_rest"):
        assert not t_state.mu[k][mask].any() and not t_state.nu[k][mask].any()
        assert t_state.mu[k][~mask].any()
    assert not t_state.mu["scene.opacity"].any() and t_state.mu["human.triplane"].any()
    _assert_tree(t_state.mu, j_state[0].mu, rtol=1e-5, atol_of=lambda w: 1e-12)
    _assert_tree(t_state.nu, j_state[0].nu, rtol=1e-5, atol_of=lambda w: 1e-18)

    # one more step: restarted rows take the global bias correction (step 6)
    import optax
    leaves, treedef = _numpy_grads(j_tr, seed=11)
    upd, j_state = jax.jit(j_opt.update)(
        jax.tree_util.tree_unflatten(treedef, list(map(jnp.asarray, leaves))), j_state, j_tr)
    j_tr = optax.apply_updates(j_tr, upd)
    t_opt.update(_as_torch(leaves), t_state, t_tr)
    assert t_state.count == int(j_state[0].count) == 6
    lr = t_opt.learning_rates(5)["scene_mean"]
    got, want = t_tr.scene.mean.detach().numpy(), np.asarray(j_tr.scene.mean)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=6 * (1e-6 * lr + np.spacing(np.float32(np.abs(want).max()))))

# --- checkpoints -------------------------------------------------------------


@pytest.fixture(scope="module")
def states(twin):
    """A JAX TrainState in mid-training (random moments, step count 7, itr
    1234, some statistics) and the port's state made from its leaves."""
    j = twin.j
    opt = j_make_optimizer(j.trainables, j.cfg, 3.0, 1000)
    state = jl.init_train_state(j.trainables, j.scene_aux, opt)
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    names = convert.TRAIN_STATE_LEAVES
    assert len(leaves) == len(names)
    new = []
    for name, x in zip(names, leaves):
        x = np.asarray(x)
        if name.endswith("count"):
            x = np.asarray(7, np.int32)
        elif name == "itr":
            x = np.asarray(1234, np.int32)
        elif ".mu." in name or ".nu." in name or name in ("scene_aux.xyz_grad_accum",
                                                          "scene_aux.track_cnt"):
            x = np.abs(rng.normal(size=x.shape)).astype(np.float32)
        new.append(jnp.asarray(x))
    j_state = jax.tree_util.tree_unflatten(treedef, new)
    t_state = convert.train_state_from_jax([np.asarray(x) for x in new], twin.t_cfg, "cpu")
    return twin, j_state, t_state


def _dotted(path):
    return ".".join(str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
                    for k in path)


def test_leaf_order_is_jax_tree_flatten(states):
    _, j_state, t_state = states
    paths, _ = jax.tree_util.tree_flatten_with_path(j_state)
    assert tuple(_dotted(p) for p, _ in paths) == convert.TRAIN_STATE_LEAVES
    assert len(convert.TRAIN_STATE_LEAVES) == 3 * 91 + 2 + 7 + 1
    # every parameter of the port appears once, placeholders besides
    named = [t for _, t, _ in convert._TRAINABLE_LEAVES if t is not None]
    assert sorted(named) == sorted(k for k, _ in t_state.trainables.named_parameters())
    assert isinstance(t_state, TrainState) and t_state.itr == 1234
    assert t_state.opt_state.count == 7


def _assert_leaves_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _j_leaves(j_state):
    return dict(zip(convert.TRAIN_STATE_LEAVES,
                    (np.asarray(x) for x in jax.tree_util.tree_leaves(j_state))))


def test_state_conversion_is_lossless(states):
    _, j_state, t_state = states
    _assert_leaves_equal(convert.train_state_to_numpy(t_state), _j_leaves(j_state))
    # Linear weights are transposed on the way in
    w = np.asarray(j_state.trainables.human.geo_net.weights[0])
    assert t_state.trainables.human.geo_net.linears[0].weight.shape == w.T.shape


def test_round_trip_in_the_port(states, tmp_path):
    twin, _, t_state = states
    assert tck.latest_checkpoint(str(tmp_path)) is None
    tck.save_checkpoint(str(tmp_path), t_state, epoch=0)
    p = tck.save_checkpoint(str(tmp_path), t_state, epoch=12)
    tck.save_checkpoint(str(tmp_path), t_state, epoch=3)
    assert tck.latest_checkpoint(str(tmp_path)) == p
    restored, epoch = tck.load_checkpoint(p, twin.t_cfg, device="cpu")
    assert epoch == 12
    _assert_leaves_equal(convert.train_state_to_numpy(restored),
                         convert.train_state_to_numpy(t_state))
    assert restored.trainables is not t_state.trainables
    assert all(p_.requires_grad for p_ in restored.trainables.parameters())
    assert restored.scene_aux.live.dtype == torch.bool


def test_jax_snapshot_loads_into_the_port(states, tmp_path):
    twin, j_state, t_state = states
    p = jck.save_checkpoint(str(tmp_path), j_state, epoch=4)
    assert tck.latest_checkpoint(str(tmp_path)) == p
    restored, epoch = tck.load_checkpoint(p, twin.t_cfg, device="cpu")
    assert epoch == 4
    _assert_leaves_equal(convert.train_state_to_numpy(restored), _j_leaves(j_state))


def test_port_snapshot_loads_into_jax(states, tmp_path):
    _, j_state, t_state = states
    p = tck.save_checkpoint(str(tmp_path), t_state, epoch=9)
    assert jck.latest_checkpoint(str(tmp_path)) == p
    template = jax.tree.map(jnp.zeros_like, j_state)
    restored, epoch = jck.load_checkpoint(p, template)
    assert epoch == 9
    _assert_leaves_equal(_j_leaves(restored), _j_leaves(j_state))
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(j_state)


def test_wrong_leaf_count_is_refused(states, tmp_path):
    twin, *_ = states
    path = str(tmp_path / "snapshot_1.npz")
    np.savez(path, leaf_0=np.zeros(3), num_leaves=np.asarray(1), epoch=np.asarray(1))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_checkpoint(path, twin.t_cfg, device="cpu")
