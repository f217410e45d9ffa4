"""Checkpoints of the PyTorch port and of the JAX package, both ways, on the
CPU: the port's static leaf list against ``jax.tree_util.tree_flatten_with_path``
of the JAX ``TrainState``; a round trip inside the port (every leaf bit for
bit); a snapshot written by the JAX package loaded into the port; one written
by the port loaded into the JAX package with a JAX template. Every comparison
is exact: a checkpoint moves bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.train import checkpoint as jck
from exavatar_release_tpu.train import loop as jl
from exavatar_release_tpu.train.optim import make_optimizer as j_make_optimizer
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.train import checkpoint as tck
from exavatar_release_tpu_torch.train.loop import TrainState
from torch_frame_fixture import TwinFrame

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def states():
    """A JAX TrainState in mid-training (random moments, step count 7, itr
    1234, some statistics) and the port's state made from its leaves."""
    twin = TwinFrame()
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
