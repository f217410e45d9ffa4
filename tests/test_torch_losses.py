"""Losses of the PyTorch port against the JAX package on the CPU: every
function of avatar/losses.py and ops/image_metrics.py, and the LPIPS distance
for both backbones, on identical numpy inputs. rtol 1e-4 (float32 on both
sides; convolutions and sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.avatar import losses as jl
from exavatar_release_tpu.ops import image_metrics as jim
from exavatar_release_tpu.ops import lpips as jlp
from exavatar_release_tpu_torch.avatar import losses as tl
from exavatar_release_tpu_torch.avatar.convert import lpips_params_from_jax
from exavatar_release_tpu_torch.ops import image_metrics as tim
from exavatar_release_tpu_torch.ops import lpips as tlp
from torch_frame_fixture import fast_jit

torch.set_num_threads(2)
RTOL = 1e-4
J, T = jnp.asarray, torch.from_numpy


def _close(got, want, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    H, W = 40, 56
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    fg = np.zeros((1, H, W), np.float32)
    fg[:, 8:30, 10:40] = 1.0
    bbox = np.asarray([9.7, 5.2, 30.5, 28.9], np.float32)
    return a, b, fg, bbox, (H, W)


def test_windows_and_bbox_mask(imgs):
    *_, bbox, shape = imgs
    _close(tim.gaussian_window_1d(), jim.gaussian_window_1d())
    _close(tim.gaussian_window(), jim.gaussian_window())
    for bb in (bbox, np.asarray([-4.5, -2.0, 20.0, 100.0], np.float32)):  # clipped boxes too
        got, want = tim.bbox_mask(shape, T(bb)).numpy(), np.asarray(jim.bbox_mask(shape, J(bb)))
        assert 0 < want.sum() < want.size
        np.testing.assert_array_equal(got, want)


def test_ssim_psnr_masked_mean(imgs):
    a, b, fg, bbox, shape = imgs
    region = np.asarray(jim.bbox_mask(shape, J(bbox)))
    _close(tim.ssim_map(T(a), T(b)), jim.ssim_map(J(a), J(b)), atol=1e-5)
    _close(tim.ssim_map(T(a), T(b), mask=T(fg)), jim.ssim_map(J(a), J(b), mask=J(fg)), atol=1e-5)
    # zero padding: the border of a constant image sees the window cut off
    one = np.ones((3,) + shape, np.float32)
    _close(tim.ssim_map(T(one), T(one * 0.5)), jim.ssim_map(J(one), J(one * 0.5)), atol=1e-5)
    _close(tim.psnr(T(a), T(b)), jim.psnr(J(a), J(b)))
    _close(tim.psnr(T(a), T(b), mask=T(region)), jim.psnr(J(a), J(b), mask=J(region)))
    _close(tim.masked_mean(T(a), T(region)), jim.masked_mean(J(a), J(region)))
    _close(tim.masked_mean(T(a[0]), T(region)), jim.masked_mean(J(a[0]), J(region)))
    _close(tim.masked_mean(T(a), None), jim.masked_mean(J(a), None))


def test_image_losses(imgs):
    a, b, fg, bbox, shape = imgs
    region = np.asarray(jim.bbox_mask(shape, J(bbox)))
    bg = np.asarray([0.2, 0.5, 0.9], np.float32)
    _close(tl.rgb_l1(T(a), T(b)), jl.rgb_l1(J(a), J(b)))
    _close(tl.rgb_l1(T(a), T(b), T(region)), jl.rgb_l1(J(a), J(b), J(region)))
    _close(tl.rgb_l1(T(a), T(b), T(region), fg_mask=T(fg), bg=T(bg)),
           jl.rgb_l1(J(a), J(b), J(region), fg_mask=J(fg), bg=J(bg)))
    _close(tl.rgb_l1_weighted_full(T(a), T(b), T(1 - fg)),
           jl.rgb_l1_weighted_full(J(a), J(b), J(1 - fg)))
    _close(tl.ssim_loss(T(a), T(b), T(region)), jl.ssim_loss(J(a), J(b), J(region)))
    _close(tl.ssim_loss(T(a), T(b), mul_mask=T(1 - fg)),
           jl.ssim_loss(J(a), J(b), mul_mask=J(1 - fg)))


# jitted: run op by op, the JAX initialiser and distance cost ~200 small compiles
_j_lpips_random = fast_jit(jlp.init_lpips_random, static_argnums=(1,))
_j_lpips_distance = fast_jit(jlp.lpips_distance)
_j_lpips_loss = fast_jit(jl.lpips_loss)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_distance(imgs, net, tmp_path):
    a, b, _, bbox, shape = imgs
    if net == "alex":  # its stride-4 stem and two 3x3 pools need a larger image
        rng = np.random.default_rng(1)
        shape = (72, 96)
        a = rng.uniform(0, 1, (3,) + shape).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        bbox = np.asarray([20.3, 10.1, 50.0, 48.8], np.float32)
    jp = _j_lpips_random(jax.random.PRNGKey(1), net)
    npy = lambda xs: [np.asarray(x) for x in xs]
    tp = lpips_params_from_jax(npy(jp.conv_weights), npy(jp.conv_biases), npy(jp.lin_weights),
                               jp.net, device="cpu")
    region = np.asarray(jim.bbox_mask(shape, J(bbox)))
    a2, b2 = a * 2 - 1, b * 2 - 1
    want = float(_j_lpips_distance(jp, J(a2), J(b2)))
    assert want > 0
    _close(tlp.lpips_distance(tp, T(a2), T(b2)), want)
    _close(tlp.lpips_distance(tp, T(a2), T(b2), mask=T(region)),
           _j_lpips_distance(jp, J(a2), J(b2), mask=J(region)))
    _close(tl.lpips_loss(tp, T(a), T(b), T(region)), _j_lpips_loss(jp, J(a), J(b), J(region)))
    # the .npz layout is shared: what the JAX package saves, the port loads
    jlp.save_lpips(str(tmp_path / "j.npz"), jp)
    loaded = tlp.load_lpips(str(tmp_path / "j.npz"), device="cpu")
    assert loaded.net == net
    _close(tlp.lpips_distance(loaded, T(a2), T(b2)), want)
    tlp.save_lpips(str(tmp_path / "t.npz"), tp)
    _close(_j_lpips_distance(jlp.load_lpips(str(tmp_path / "t.npz")), J(a2), J(b2)), want)


@pytest.fixture(scope="module")
def body():
    """A closed bumpy tube as a stand-in body mesh with part labels."""
    rng = np.random.default_rng(3)
    rings, segs = 10, 12
    th = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    v = np.stack([np.stack([0.1 * np.cos(th), np.full(segs, 0.05 * r), 0.1 * np.sin(th)], 1)
                  for r in range(rings)]).reshape(-1, 3)
    v = (v + rng.normal(0, 0.004, v.shape)).astype(np.float32)
    idx = np.arange(rings * segs).reshape(rings, segs)
    a, b = idx[:-1], np.roll(idx[:-1], -1, 1)
    c, d = idx[1:], np.roll(idx[1:], -1, 1)
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([c, b, d], -1).reshape(-1, 3)]).astype(np.int32)
    return v, faces, rng


def test_laplacians(body):
    v, faces, rng = body
    V = len(v)
    ji, jw = jl.build_laplacian_neighbors(faces, V)
    ti, tw = tl.build_laplacian_neighbors(faces, V)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    xs = [rng.normal(size=(V, c)).astype(np.float32) for c in (3, 1, 3)]
    wmap = rng.uniform(0, 2, V).astype(np.float32)
    for g, w in zip(tl.laplacian_multi([T(x) for x in xs], T(ti), T(tw)),
                    jl.laplacian_multi([J(x) for x in xs], J(ji), J(jw))):
        _close(g, w, atol=1e-5)
    _close(tl.laplacian(T(xs[0]), T(ti), T(tw)), jl.laplacian(J(xs[0]), J(ji), J(jw)), atol=1e-5)
    _close(tl.laplacian_reg(T(xs[0]), T(xs[2]), T(ti), T(tw), T(wmap)),
           jl.laplacian_reg(J(xs[0]), J(xs[2]), J(ji), J(jw), J(wmap)))
    _close(tl.laplacian_reg(T(xs[1]), None, T(ti), T(tw)),
           jl.laplacian_reg(J(xs[1]), None, J(ji), J(jw)))


def test_joint_regs():
    rng = np.random.default_rng(4)
    (tr, tll), (jr, jll) = tl.symmetric_joint_pairs(), jl.symmetric_joint_pairs()
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tll, jll)
    jo = rng.normal(0, 0.01, (55, 3)).astype(np.float32)
    _close(tl.joint_offset_symmetric_reg(T(jo), T(tr), T(tll)),
           jl.joint_offset_symmetric_reg(J(jo), J(jr), J(jll)))


def test_hand_and_arm_regs(body):
    v, faces, rng = body
    V = len(v)
    off = rng.normal(0, 0.01, (V, 3)).astype(np.float32)
    off[:7] = 0.0  # exactly-zero offsets: the degenerate-norm guard
    is_r = np.arange(V) % 5 == 0
    is_l = np.arange(V) % 5 == 1
    rgb = rng.uniform(0, 1, (V, 3)).astype(np.float32)

    def both(fn_t, fn_j, t_args, j_args, wrt):
        """Value and gradient with respect to argument ``wrt``."""
        t_args = list(t_args)
        t_args[wrt] = t_args[wrt].clone().requires_grad_(True)
        val = fn_t(*t_args)
        val.backward()
        jval, jg = fast_jit(jax.value_and_grad(fn_j, argnums=wrt))(*j_args)
        _close(val, jval)
        assert np.isfinite(t_args[wrt].grad.numpy()).all()
        s = max(float(np.abs(np.asarray(jg)).max()), 1e-12)
        np.testing.assert_allclose(t_args[wrt].grad.numpy() / s, np.asarray(jg) / s, atol=1e-4)

    both(tl.hand_mean_reg, jl.hand_mean_reg, (T(v), T(off), T(faces), T(is_r | is_l)),
         (J(v), J(off), J(faces), J(is_r | is_l)), wrt=1)
    both(tl.hand_rgb_reg, jl.hand_rgb_reg, (T(rgb), T(is_r), T(is_l)),
         (J(rgb), J(is_r), J(is_l)), wrt=0)
    upper = np.arange(0, V, 2).astype(np.int32)  # 60 > top_k = 50 candidates
    lower = np.arange(1, V, 2).astype(np.int32)
    both(tl.arm_rgb_reg, jl.arm_rgb_reg, (T(v), T(upper), T(lower), T(rgb)),
         (J(v), J(upper), J(lower), J(rgb)), wrt=3)
    both(lambda *a: tl.arm_rgb_reg(*a, top_k=5), lambda *a: jl.arm_rgb_reg(*a, top_k=5),
         (T(v), T(upper), T(lower), T(rgb)), (J(v), J(upper), J(lower), J(rgb)), wrt=3)
