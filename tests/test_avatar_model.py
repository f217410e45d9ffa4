"""Full avatar model forward: loss terms, gradients, test-mode outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exavatar_release_tpu.avatar.model import forward_frame, total_loss
from avatar_fixture import AvatarSetup, forward_frame_program
from fast_compile import fast_jit

TRAIN_LOSS_KEYS = {
    "rgb_human", "ssim_human", "lpips_human", "rgb_face", "rgb_human_rand_bg",
    "rgb_human_refined", "ssim_human_refined", "lpips_human_refined",
    "rgb_face_refined", "rgb_human_refined_rand_bg",
    "rgb_scene", "ssim_scene",
    "gaussian_mean_reg", "gaussian_mean_hand_reg", "gaussian_scale_reg",
    "lap_mean", "lap_scale", "lap_rgb",
    "hand_rgb_reg", "arm_rgb_reg", "joint_offset_reg", "joint_offset_sym_reg",
}

POSE_LOSS_KEYS = {
    "rgb_human", "ssim_human", "lpips_human", "rgb_face", "rgb_human_rand_bg",
    "rgb_human_refined", "ssim_human_refined", "lpips_human_refined",
    "rgb_face_refined", "rgb_human_refined_rand_bg",
}


@pytest.fixture(scope="module")
def setup():
    return AvatarSetup()


def _fwd(s, mode="train", fit_pose=False, cfg=None):
    return forward_frame_program(
        *s.forward_inputs([0.3, 0.5, 0.7]),
        s.cfg if cfg is None else cfg,
        is_warmup=True,
        mode=mode,
        fit_pose_to_test=fit_pose,
        settings=s.settings,
    )


def _loss(trainables, offset, *inputs, **kw):
    """The total train loss of forward_frame(trainables, *inputs)."""
    out = forward_frame(trainables, *inputs, scene_mean2d_offset=offset, **kw)
    return total_loss(out.losses)


# d(loss)/d(trainables, offset) as one program
_loss_grads = fast_jit(
    jax.grad(_loss, argnums=(0, 1)),
    static_argnames=("cfg", "is_warmup", "mode", "settings"),
)


def _grads(s, offset=None):
    trainables, *inputs = s.forward_inputs([0.3, 0.5, 0.7])
    return _loss_grads(trainables, offset, *inputs, cfg=s.cfg, is_warmup=True,
                       mode="train", settings=s.settings)


@pytest.fixture(scope="module")
def train_out(setup):
    """The train-mode forward that several tests read."""
    return _fwd(setup)


class TestForward:
    def test_train_losses_complete_and_finite(self, train_out):
        out = train_out
        assert set(out.losses.keys()) == TRAIN_LOSS_KEYS
        for k, v in out.losses.items():
            assert np.isfinite(float(v)), k
            assert float(v) >= 0, k
        tot = total_loss(out.losses)
        assert np.isfinite(float(tot)) and float(tot) > 0

    def test_fit_pose_subset(self, setup):
        out = _fwd(setup, fit_pose=True)
        assert set(out.losses.keys()) == POSE_LOSS_KEYS

    def test_test_mode_outputs(self, setup):
        out = _fwd(setup, mode="test")
        H, W = setup.H, setup.W
        for k in (
            "scene_img", "human_img", "scene_human_img", "human_img_refined",
            "scene_human_img_refined", "scene_human_img_composed",
            "scene_human_img_refined_composed", "human_face_img",
            "human_face_img_refined",
        ):
            assert k in out.renders, k
            assert out.renders[k].shape[:2] == (H, W), k
            assert np.isfinite(np.asarray(out.renders[k])).all(), k
        assert out.losses == {}

    def test_grads_reach_all_trainables(self, setup):
        g, _ = _grads(setup)
        # scene branch is detached in scene_human renders but has its own
        # scene losses; human nets must get gradients; frame poses too
        assert float(jnp.abs(g.scene.mean).sum()) > 0
        assert float(jnp.abs(g.scene.opacity).sum()) > 0
        assert float(jnp.abs(g.human.triplane).sum()) > 0
        assert float(jnp.abs(g.human.shape_param).sum()) > 0
        assert float(jnp.abs(g.human.joint_offset).sum()) > 0
        assert float(jnp.abs(g.frames.body_pose).sum()) > 0
        assert float(jnp.abs(g.frames.trans).sum()) > 0
        for w in g.human.rgb_net.weights:
            assert np.isfinite(np.asarray(w)).all()

    def test_scene_mean2d_grad_for_densify(self, setup):
        C = setup.scene_state.capacity
        offset = jnp.zeros((C, 2))
        _, g = _grads(setup, offset)
        assert g.shape == (C, 2)
        assert np.isfinite(np.asarray(g)).all()
        # some live gaussians must receive screen-space gradient
        assert float(jnp.abs(g).sum()) > 0

    def test_jit_stability(self, setup):
        s = setup

        @jax.jit
        def step(tr, frame):
            out = forward_frame(
                tr, s.scene_state.aux, s.buffers, s.prior, s.statics,
                s.id_info, s.lpips, s.face_texture, s.face_texture_mask,
                s.init_joint_offset, frame, jnp.asarray([0.1, 0.1, 0.1]),
                s.cfg, is_warmup=True, mode="train", settings=s.settings,
            )
            return total_loss(out.losses)

        l0 = float(step(s.trainables, s.frame_data[0]))
        l1 = float(step(s.trainables, s.frame_data[1]))
        assert np.isfinite(l0) and np.isfinite(l1)
        assert l0 != l1  # different frames -> different loss


def test_face_window_render_matches_full(setup, train_out):
    """The static face-render window (AvatarConfig.face_render_h/w) must be
    an EXACT optimization: with a window that covers the projected face,
    every loss matches the full-frame mesh render bit-for-bit-ish."""
    import dataclasses

    s = setup
    out_full = train_out
    cfg_win = dataclasses.replace(
        s.cfg, face_render_h=s.H - 8, face_render_w=s.W - 16
    )
    out_win = _fwd(s, cfg=cfg_win)
    for k in out_full.losses:
        np.testing.assert_allclose(
            float(out_win.losses[k]), float(out_full.losses[k]),
            rtol=1e-5, err_msg=f"loss {k} changed under the face window",
        )
