"""``loss_and_grads`` of the PyTorch port against ``jax.value_and_grad`` of
the JAX package's train-step loss on the CPU (tests/torch_frame_fixture.py),
after warm-up, backend "ref" on both sides: every loss of the dict (rtol
1e-3), and the gradient of every leaf of the trainables and of the (C, 2)
screen-space offset, each scaled by its reference's largest magnitude (atol
1e-3; the worst leaf measured when this was written: 1.5e-5,
human.triplane_face)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar.model import forward_frame as j_forward_frame
from exavatar_release_tpu.avatar.model import total_loss as j_total_loss
from exavatar_release_tpu_torch.avatar.convert import human_params_from_jax
from exavatar_release_tpu_torch.train.loop import loss_and_grads
from torch_frame_fixture import TwinFrame, _fields, compile_once

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def step():
    tw = TwinFrame()
    j = tw.j
    C = j.scene_state.capacity

    def loss_fn(tr, off):
        out = j_forward_frame(
            tr, j.scene_aux, j.buffers, j.prior, j.statics, j.id_info, j.lpips, j.face_texture,
            j.face_texture_mask, j.init_joint_offset, j.frame_data[0], tw.j_bg, j.cfg,
            is_warmup=False, mode="train", settings=j.settings, scene_mean2d_offset=off)
        return j_total_loss(out.losses), out.losses

    args = (j.trainables, jnp.zeros((C, 2)))
    (tot, losses), (g_tr, g_off) = compile_once(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True), *args)(*args)
    want = {"scene." + k: v for k, v in _fields(g_tr.scene).items()}
    want.update({"human." + k: v.numpy()
                 for k, v in human_params_from_jax(_fields(g_tr.human)).items()})
    want.update({"frames." + k: v for k, v in _fields(g_tr.frames).items()})
    before = {k: v.detach().clone() for k, v in tw.t_trainables.named_parameters()}
    got = loss_and_grads(tw.t_trainables, tw.t_scene_aux, tw.t_bundle, tw.t_frame(0), tw.t_bg,
                         tw.t_cfg, is_warmup=False, settings=tw.t_settings)
    return tw, float(tot), losses, want, np.asarray(g_off), got, before


def test_losses_after_warmup(step):
    _, tot, losses, _, _, (t_tot, out, _, _), _ = step
    assert set(out.losses) == set(losses) and len(losses) == 22
    for k, w in losses.items():
        np.testing.assert_allclose(float(out.losses[k]), float(w), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(t_tot), tot, rtol=1e-4)
    assert not t_tot.requires_grad
    assert all(not v.requires_grad for v in out.renders.values())


def test_gradient_of_every_leaf(step):
    tw, _, _, want, _, (_, _, grads, _), _ = step
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


def test_mean2d_offset_gradient(step):
    tw, _, _, _, g_off, (_, out, _, g2d), _ = step
    assert tuple(g2d.shape) == g_off.shape == (tw.j.scene_state.capacity, 2)
    assert float(np.abs(g_off).max()) > 0
    err = float(np.abs(g2d.numpy() - g_off).max()) / float(np.abs(g_off).max())
    assert err <= 1e-3, err
    # dead rows and rows off screen get none
    live = np.asarray(tw.j.scene_aux.live)
    assert not g2d.numpy()[~live].any()
    assert not g2d.numpy()[~out.scene_is_vis.numpy()].any()


def test_step_leaves_parameters_untouched(step):
    tw, *_, before = step
    for k, p in tw.t_trainables.named_parameters():
        assert p.grad is None, k
        assert torch.equal(p.detach(), before[k]), k
