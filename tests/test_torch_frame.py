"""``forward_frame`` of the PyTorch port against the JAX package on the CPU,
on one synthetic avatar carried across as numpy (tests/torch_frame_fixture.py):
test mode (every render key, atol 1e-4) and train mode (every loss of the
dict, rtol 1e-3) during warm-up and when fitting poses to test frames (there
with a face window and an LPIPS crop smaller than the frame);
backend "ref" on both sides. The step after warm-up and the gradients are in
tests/test_torch_frame_grad.py."""
import dataclasses

import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar.model import forward_frame as j_forward_frame
from exavatar_release_tpu_torch.avatar.model import forward_frame as t_forward_frame
from exavatar_release_tpu_torch.avatar.model import total_loss as t_total_loss
from torch_frame_fixture import TwinFrame, compile_once

torch.set_num_threads(2)

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


@pytest.fixture(scope="module")
def twin():
    return TwinFrame()


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
