"""The optimizer of the PyTorch port against the JAX package's (optax) on the
CPU.

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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.train import optim as jo
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.train import optim as to
from torch_frame_fixture import TwinFrame

torch.set_num_threads(2)

TOT = 1000
RADIUS = 3.0


@pytest.fixture(scope="module")
def twin():
    return TwinFrame()


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
