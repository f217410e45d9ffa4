"""Gradients of the port's rasterizer on the CPU.

* the plain backward functions against the Pallas backward kernels in
  interpret mode (scaled atol 2.5e-2, the kernel tolerance of
  tests/test_goldens.py: log-space bf16 prefix sums against a sequential
  float32 replay);
* the plain backward functions against ``torch.autograd`` over the plain
  forward with a straight-through alpha clamp (scaled atol 1e-5). The
  backward follows renderCUDA and the Pallas kernels: d alpha / d q = exp(q)
  also where alpha was clamped to 0.99, where autograd (and ``jax.grad`` over
  jax_ref, which made the goldens) gives zero;
* ``rasterize``'s input gradients on tests/goldens/scene*.npz: backend "ref"
  meets the goldens at 1e-5; the dense and pair-major paths meet the
  straight-through reference at 1e-5 in every scene, and the goldens at 1e-5
  in the three scenes where no Gaussian clamps and at 2.5e-2 in scene2, whose
  opaque front layer clamps;
* ``mean2d_offset``: forward and d loss / d offset against the JAX package,
  backend "ref" on both sides.

The comparisons with the goldens and with the JAX package run under the
seam of tests/torch_xla_math.py (XLA's transcendentals for the port's) and,
as the ``torch_libm`` cases, on the port's own libm, at the same bounds.
"""
import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core.camera import Camera as JCamera
from exavatar_release_tpu.ops.rasterizer import RasterizeSettings as JSettings
from exavatar_release_tpu.ops.rasterizer import pallas_kernels as pk
from exavatar_release_tpu.ops.rasterizer import rasterize as j_rasterize
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize
from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from torch_frame_fixture import fast_jit
from torch_windows import ragged, windows
from torch_xla_math import seam_cases, xla_transcendentals

torch.set_num_threads(2)

GOLDENS = sorted(glob.glob(osp.join(osp.dirname(osp.abspath(__file__)), "goldens", "*.npz")))
TILE = (8, 128)
BG = np.asarray([1.0, 0.5, 0.25], np.float32)
G_NAMES = ("g_means3d", "g_scales", "g_quats", "g_opacities", "g_rgbs")


_clamp = torch.clamp


class _StraightThroughClamp(torch.autograd.Function):
    """min(x, 0.99) whose gradient passes where the clamp binds."""

    @staticmethod
    def forward(ctx, x):
        return _clamp(x, max=kn.ALPHA_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


def _patch_alpha_clamp(monkeypatch):
    """Until the test ends, ``torch.clamp(x, max=ALPHA_MAX)``, the plain
    forward's alpha clamp, passes its gradient where it binds; every other
    ``torch.clamp`` call is the original."""

    def clamp(x, min=None, max=None, **kw):
        if min is None and max == kn.ALPHA_MAX and not kw:
            return _StraightThroughClamp.apply(x)
        return _clamp(x, min=min, max=max, **kw)

    monkeypatch.setattr(torch, "clamp", clamp)


@pytest.fixture
def straight_through(monkeypatch):
    _patch_alpha_clamp(monkeypatch)


def _scaled(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def scene():
    """4 tiles of 8x128, K = 256; some opaque Gaussians sit on pixel centers,
    so that alpha clamps at 0.99 and pixels terminate."""
    rng = np.random.default_rng(21)
    win, counts, origins = windows(rng, T=4, K=256, tile_shape=TILE, nx=2)
    win[:, 5, ::9] = 0.0  # opacity 1
    win[:, 3, ::9] = np.round(win[:, 3, ::9])
    win[:, 4, ::9] = np.round(win[:, 4, ::9])
    win[1, 5, int(counts[1]):] = -1e9  # rows past the count stay padding
    g_full = rng.normal(size=(4, 5, TILE[0] * TILE[1])).astype(np.float32)
    return win, counts, origins, g_full


def test_plain_dense_bwd_vs_pallas_interpret(scene):
    win, counts, origins, g_full = scene
    j = jnp.asarray
    full = pk.composite_tiles_fwd_cm(j(win), j(counts), j(origins), j(BG), TILE, chunk=128,
                                     interpret=True)
    want = pk.composite_tiles_bwd_cm(j(win), j(counts), j(origins), j(BG), full, j(g_full), TILE,
                                     chunk=128, interpret=True)
    # each backward replays its own forward: the saved output must come from
    # the forward whose termination decisions the replay repeats
    t = torch.from_numpy
    t_full = kn.composite_tiles_fwd_cm(t(win), t(counts), t(origins), t(BG), TILE)
    got = kn.composite_tiles_bwd_cm(t(win), t(counts), t(origins), t(BG), t_full, t(g_full),
                                    TILE)
    assert got.shape == want.shape
    assert _scaled(got, want) <= 2.5e-2
    assert not got[:, 6:8].any() and not got[1, :, int(counts[1]):].any()


def test_plain_ragged_bwd_vs_pallas_interpret(scene):
    win, counts, _, g_full = scene
    rows, tid, flags = ragged(win, counts, 128)
    j = jnp.asarray
    args = (j(rows), j(tid), j(flags), j(BG), jnp.float32(0.0))
    full = pk.composite_pairs_fwd_rg(*args, TILE, 4, 128, 2, interpret=True)
    want = pk.composite_pairs_bwd_rg(*args, full, j(g_full), TILE, 4, 128, 2, interpret=True)
    t = torch.from_numpy
    t_full = kn.composite_pairs_fwd_rg(t(rows), t(tid), t(flags), t(BG), 0.0, TILE, 4, 128, 2)
    got = kn.composite_pairs_bwd_rg(t(rows), t(tid), t(flags), t(BG), 0.0, t_full, t(g_full),
                                    TILE, 4, 128, 2)
    assert got.shape == want.shape
    assert _scaled(got, want) <= 2.5e-2
    # padding rows and the trailing invalid slot: exact zeros
    assert not got[:, rows[5] <= -1e9].any() and not got[:, -128:].any()


def test_plain_bwd_vs_autograd(scene, straight_through):
    win, counts, origins, g_full = scene
    t = torch.from_numpy
    w = t(win).requires_grad_(True)
    bg = t(BG).requires_grad_(True)
    full = kn.composite_tiles_fwd_cm_plain(w, t(counts), t(origins), bg, TILE)
    assert (full[:, 4] > 1 - 2e-4).any()  # some pixels terminated
    (full * t(g_full)).sum().backward()
    dwin, stats = kn.composite_bwd_plain_with_stats(t(win), t(counts), t(origins), t(BG),
                                                    full.detach(), t(g_full), TILE)
    assert 0 < stats.hits < stats.visits
    assert _scaled(dwin, w.grad) <= 1e-5
    # and row by row, each against its own largest value (rows 6-7 are zero)
    err, ref = kn.bwd_row_errors(dwin, w.grad, 1)
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
    assert float(ref[used].min()) > 0 and not err[6:8].any() and not ref[6:8].any()
    assert float((err[used] / ref[used]).max()) <= 1e-5
    # the same rows as a ragged pair list give the same gradients, slot by slot
    rows, tid, flags = ragged(win, counts, 128)
    drows = kn.composite_pairs_bwd_rg_plain(t(rows), t(tid), t(flags), t(BG), 0.0,
                                            full.detach(), t(g_full), TILE, 4, 128, 2)
    want_rows, _, _ = ragged(dwin.numpy(), counts, 128)
    want_rows[5, rows[5] <= -1e9] = 0.0  # `ragged` pads log_op with -1e9
    np.testing.assert_array_equal(drows.numpy(), want_rows)


def test_clamped_gaussian_keeps_its_gradient(scene):
    """One opaque Gaussian on a pixel center: alpha clamps there. Autograd
    over the plain forward loses that pixel's share; the backward keeps it."""
    t = torch.from_numpy
    win = np.zeros((1, 12, 1), np.float32)
    win[0, :, 0] = [0.5, 0.0, 0.5, 3.0, 2.0, 0.0, 0, 0, 1.0, 0.0, 0.0, 2.0]
    counts, origins = np.ones(1, np.int32), np.zeros((1, 2), np.float32)
    g_full = np.zeros((1, 5, 8 * 128), np.float32)
    g_full[0, 0, 2 * 128 + 3] = 1.0  # only the pixel under the center counts
    w = t(win).requires_grad_(True)
    full = kn.composite_tiles_fwd_cm_plain(w, t(counts), t(origins), t(BG * 0), TILE)
    assert float(full.detach()[0, 4, 2 * 128 + 3]) == pytest.approx(0.99)
    (full * t(g_full)).sum().backward()
    assert float(w.grad[0, 5, 0]) == 0.0
    dwin = kn.composite_tiles_bwd_cm_plain(t(win), t(counts), t(origins), t(BG * 0),
                                           full.detach(), t(g_full), TILE)
    # d img_r / d log_op = color_r * exp(q) = 1 at the center
    assert float(dwin[0, 5, 0]) == pytest.approx(1.0, abs=1e-6)


def _golden(path):
    d = dict(np.load(path))
    H, W = int(d["H"]), int(d["W"])
    f = float(d["focal"])
    cam = TCamera(torch.eye(3), torch.zeros(3), torch.tensor([f, f]),
                  torch.tensor([W / 2.0, H / 2.0]))
    return d, cam, (H, W)


def _t_loss(r, shape):
    """The fixed cotangent of tests/test_goldens.py:_loss."""
    H, W = shape
    wimg = (torch.arange(H * W * 3, dtype=torch.float32).reshape(H, W, 3) % 7.0 + 1.0) / 7.0
    wd = (torch.arange(H * W, dtype=torch.float32).reshape(H, W) % 5.0 + 1.0) / 5.0
    return ((r["img"] * wimg).sum() + (r["depth"] * wd).sum()
            + (r["mask"] * wd.T.reshape(H, W)).sum())


def _input_grads(d, cam, shape, settings):
    args = [torch.from_numpy(d[k]).requires_grad_(True)
            for k in ("means3d", "scales", "quats", "opacities", "rgbs")]
    out = rasterize(*args, torch.from_numpy(d["live"]), cam, shape, torch.from_numpy(d["bg"]),
                    settings)
    _t_loss(out, shape).backward()
    return [a.grad for a in args]


_BASE = dict(tile_h=8, tile_w=128, max_per_tile=64, chunk=32)


@pytest.mark.parametrize("path, seam", seam_cases({osp.basename(p): p for p in GOLDENS}))
def test_golden_grads_ref_backend(path, seam):
    d, cam, shape = _golden(path)
    with xla_transcendentals(seam):
        got = _input_grads(d, cam, shape, RasterizeSettings(backend="ref", **_BASE))
    for g, name in zip(got, G_NAMES):
        assert _scaled(g, d[name]) <= 1e-5, name


@pytest.mark.parametrize("path, pair_major, seam", seam_cases(
    {osp.basename(p): p for p in GOLDENS}, {"dense": False, "pair_major": True}))
def test_golden_grads_kernel_paths(path, pair_major, seam, monkeypatch):
    d, cam, shape = _golden(path)
    with xla_transcendentals(seam):
        got = _input_grads(d, cam, shape, RasterizeSettings(pair_major=pair_major, **_BASE))
    clamps = osp.basename(path) == "scene2.npz"
    for g, name in zip(got, G_NAMES):
        assert _scaled(g, d[name]) <= (2.5e-2 if clamps else 1e-5), name
    # and at 1e-5 in every scene against autograd with the unclamped rule
    _patch_alpha_clamp(monkeypatch)
    with xla_transcendentals(seam):
        want = _input_grads(d, cam, shape, RasterizeSettings(backend="ref", **_BASE))
    worst = max(_scaled(g, w) for g, w in zip(got, want))
    assert worst <= 1e-5, worst
    if clamps:  # the rule matters here: scene2 does clamp
        assert max(_scaled(w, d[n]) for w, n in zip(want, G_NAMES)) > 1e-4


def test_no_grad_saves_nothing():
    d, cam, shape = _golden(GOLDENS[0])
    args = [torch.from_numpy(d[k]).requires_grad_(True)
            for k in ("means3d", "scales", "quats", "opacities", "rgbs")]
    with torch.no_grad():
        out = rasterize(*args, torch.from_numpy(d["live"]), cam, shape,
                        torch.from_numpy(d["bg"]), RasterizeSettings(**_BASE))
    assert out["img"].grad_fn is None and not out["img"].requires_grad


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_mean2d_offset_forward_and_grad(seam):
    d, cam, shape = _golden(GOLDENS[1])
    rng = np.random.default_rng(5)
    n = d["means3d"].shape[0]
    off = rng.normal(0, 1.5, (n, 2)).astype(np.float32)
    keys = ("means3d", "scales", "quats", "opacities", "rgbs", "live")
    jcam = JCamera(R=jnp.eye(3), t=jnp.zeros(3), focal=jnp.asarray(cam.focal.numpy()),
                   princpt=jnp.asarray(cam.princpt.numpy()))
    jset = JSettings(backend="ref", **_BASE)

    def j_loss(o):
        r = j_rasterize(*(jnp.asarray(d[k]) for k in keys), jcam, shape, jnp.asarray(d["bg"]),
                        jset, mean2d_offset=o)
        H, W = shape
        wimg = (jnp.arange(H * W * 3, dtype=jnp.float32).reshape(H, W, 3) % 7.0 + 1.0) / 7.0
        wd = (jnp.arange(H * W, dtype=jnp.float32).reshape(H, W) % 5.0 + 1.0) / 5.0
        return (jnp.sum(r["img"] * wimg) + jnp.sum(r["depth"] * wd)
                + jnp.sum(r["mask"] * wd.T.reshape(H, W))), r

    (_, want), g_want = fast_jit(jax.value_and_grad(j_loss, has_aux=True))(jnp.asarray(off))
    to = torch.from_numpy(off).requires_grad_(True)
    with xla_transcendentals(seam):
        got = rasterize(*(torch.from_numpy(d[k]) for k in keys), cam, shape,
                        torch.from_numpy(d["bg"]), RasterizeSettings(backend="ref", **_BASE),
                        mean2d_offset=to)
        _t_loss(got, shape).backward()
    np.testing.assert_allclose(got["img"].detach().numpy(), np.asarray(want["img"]), atol=1e-5)
    np.testing.assert_allclose(got["mask"].detach().numpy(), np.asarray(want["mask"]), atol=1e-5)
    np.testing.assert_allclose(got["mean2d"].detach().numpy(), np.asarray(want["mean2d"]),
                               atol=1e-4)
    # the offset moved the render
    base = rasterize(*(torch.from_numpy(d[k]) for k in keys), cam, shape,
                     torch.from_numpy(d["bg"]), RasterizeSettings(backend="ref", **_BASE))
    assert float((base["img"] - got["img"].detach()).abs().max()) > 1e-2
    assert float(np.abs(np.asarray(g_want)).max()) > 0
    assert _scaled(to.grad, g_want) <= 1e-5
    # the kernel paths take the offset too
    for pm in (False, True):
        o = rasterize(*(torch.from_numpy(d[k]) for k in keys), cam, shape,
                      torch.from_numpy(d["bg"]), RasterizeSettings(pair_major=pm, **_BASE),
                      mean2d_offset=torch.from_numpy(off))
        assert torch.allclose(o["img"], got["img"].detach(), atol=1e-6)
