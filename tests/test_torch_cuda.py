"""The port's CUDA compositing kernels on the card, forward and backward:
each against its plain PyTorch version on the same CUDA tensors, the
wrappers' input checks, their launch counters, a render's gradients against
the same render on CPU tensors, and a failed build. Marked ``cuda``; skips
where there is no GPU.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with PyTorch alone (tests/conftest.py imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from torch_windows import ragged, windows

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.cuda

TILE = (32, 128)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    win, counts, origins = windows(np.random.default_rng(11), T=16, K=600, tile_shape=TILE,
                                   nx=4)
    rows, tid, flags = ragged(win, counts, 256)
    bg = np.asarray([1.0, 0.5, 0.25], np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {k: to(v) for k, v in dict(win=win, counts=counts, origins=origins, rows=rows,
                                      tid=tid, flags=flags, bg=bg).items()}


def test_dense_kernel_equals_plain(scene):
    s = scene
    got = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    want = kn.composite_tiles_fwd_cm_plain(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    torch.cuda.synchronize()
    # the kernel rounds every operation as the plain version does (-fmad=false)
    assert torch.equal(got, want)


def test_ragged_kernel_equals_plain_and_dense(scene):
    s = scene
    args = (s["rows"], s["tid"], s["flags"], s["bg"], 0.0, TILE, 16, 256, 4)
    got = kn.composite_pairs_fwd_rg(*args)
    assert torch.equal(got, kn.composite_pairs_fwd_rg_plain(*args))
    dense = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    assert torch.equal(got, dense)


def test_launch_counters(scene):
    s = scene
    n1, n2 = kn.composite_tiles_fwd_cm.launches, kn.composite_pairs_fwd_rg.launches
    kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    kn.composite_tiles_fwd_cm_plain(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    kn.composite_pairs_fwd_rg(s["rows"], s["tid"], s["flags"], s["bg"], 0.0, TILE, 16, 256, 4)
    assert kn.composite_tiles_fwd_cm.launches == n1 + 1
    assert kn.composite_pairs_fwd_rg.launches == n2 + 1


@pytest.mark.parametrize("bad", ["dtype", "strided", "shape", "device"])
def test_wrapper_rejects(scene, bad):
    s = dict(scene)
    if bad == "dtype":
        s["win"] = s["win"].double()
    elif bad == "strided":
        s["win"] = s["win"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        s["origins"] = s["origins"][:, :1].contiguous()
    else:
        s["counts"] = s["counts"].cpu()
    with pytest.raises((TypeError, ValueError)):
        kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)


@pytest.fixture(scope="module")
def cotangent(scene):
    s = scene
    full = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    g = torch.Generator().manual_seed(3)
    return full, torch.randn(full.shape, generator=g).to(full.device)


def _scaled(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


USED_ROWS = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]


def _worst_row(got, want, row_dim):
    """The largest difference of a used row over that row's own largest
    reference value: the rows differ in unit by orders of magnitude, and one
    scale for the whole tensor would hide a wrong color row."""
    err, ref = kn.bwd_row_errors(got, want, row_dim)
    assert float(ref[USED_ROWS].min()) > 0
    assert not got.select(row_dim, 6).any() and not got.select(row_dim, 7).any()
    return float((err[USED_ROWS] / ref[USED_ROWS]).max())


def test_dense_bwd_kernel_vs_plain(scene, cotangent):
    s = scene
    full, g_full = cotangent
    args = (s["win"], s["counts"], s["origins"], s["bg"], full, g_full, TILE)
    got = kn.composite_tiles_bwd_cm(*args)
    want = kn.composite_tiles_bwd_cm_plain(*args)
    torch.cuda.synchronize()
    # sums over pixels by atomics, in another order than the plain version
    assert _worst_row(got, want, 1) <= 1e-4
    past = torch.arange(got.shape[2], device=got.device)[None, :] >= s["counts"][:, None]
    assert not got.permute(0, 2, 1)[past].any()


def test_ragged_bwd_kernel_vs_plain_and_dense(scene, cotangent):
    s = scene
    full, g_full = cotangent
    args = (s["rows"], s["tid"], s["flags"], s["bg"], 0.0, full, g_full, TILE, 16, 256, 4)
    got = kn.composite_pairs_bwd_rg(*args)
    assert _worst_row(got, kn.composite_pairs_bwd_rg_plain(*args), 0) <= 1e-4
    # padding rows and the trailing invalid slot stay exactly zero
    assert not got[:, s["rows"][5] <= -1e9].any() and not got[:, -256:].any()
    dense = kn.composite_tiles_bwd_cm(s["win"], s["counts"], s["origins"], s["bg"], full, g_full,
                                      TILE)
    live = got[:, s["rows"][5] > -1e9]
    k = torch.arange(dense.shape[2], device=dense.device)[None, :] < s["counts"][:, None]
    assert _worst_row(live, dense.permute(1, 0, 2)[:, k], 0) <= 1e-4


def test_bwd_launch_counters(scene, cotangent):
    s = scene
    full, g_full = cotangent
    n1, n2 = kn.composite_tiles_bwd_cm.launches, kn.composite_pairs_bwd_rg.launches
    kn.composite_tiles_bwd_cm(s["win"], s["counts"], s["origins"], s["bg"], full, g_full, TILE)
    kn.composite_tiles_bwd_cm_plain(s["win"], s["counts"], s["origins"], s["bg"], full, g_full,
                                    TILE)
    kn.composite_pairs_bwd_rg(s["rows"], s["tid"], s["flags"], s["bg"], 0.0, full, g_full, TILE,
                              16, 256, 4)
    assert kn.composite_tiles_bwd_cm.launches == n1 + 1
    assert kn.composite_pairs_bwd_rg.launches == n2 + 1


@pytest.mark.parametrize("bad", ["dtype", "strided", "shape", "device"])
def test_bwd_wrapper_rejects(scene, cotangent, bad):
    s = dict(scene)
    full, g_full = cotangent
    if bad == "dtype":
        g_full = g_full.double()
    elif bad == "strided":  # what the image assembly's transpose hands back
        g_full = g_full.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        full = full[:, :4].contiguous()
    else:
        g_full = g_full.cpu()
    with pytest.raises((TypeError, ValueError)):
        kn.composite_tiles_bwd_cm(s["win"], s["counts"], s["origins"], s["bg"], full, g_full, TILE)
    with pytest.raises((TypeError, ValueError)):
        kn.composite_pairs_bwd_rg(s["rows"], s["tid"], s["flags"], s["bg"], 0.0, full, g_full,
                                  TILE, 16, 256, 4)


@pytest.mark.parametrize("pair_major", [False, True], ids=["dense", "pair_major"])
def test_rasterize_gradients_card_vs_cpu(dev, pair_major):
    """The whole differentiable render: the kernels on the card against
    their plain versions on CPU tensors; one forward and one backward
    launch per render."""
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize

    rng = np.random.default_rng(5)
    n, H, W, f = 400, 96, 256, 150.0
    z = rng.uniform(2.0, 4.0, (n, 1))
    d = dict(
        means3d=np.concatenate([rng.uniform(-0.5, 0.5, (n, 1)) * (W / f) * z,
                                rng.uniform(-0.5, 0.5, (n, 1)) * (H / f) * z, z], 1),
        scales=np.exp(rng.uniform(np.log(0.02), np.log(0.1), (n, 3))),
        quats=rng.normal(size=(n, 4)), opacities=rng.uniform(0.3, 1.0, (n, 1)),
        rgbs=rng.uniform(0, 1, (n, 3)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    s = RasterizeSettings(tile_h=32, tile_w=128, max_per_tile=512, pair_major=pair_major)

    def grads(device):
        cam = Camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                     torch.tensor([f, f], device=device),
                     torch.tensor([W / 2.0, H / 2.0], device=device))
        args = [torch.from_numpy(v).to(device).requires_grad_(True) for v in d.values()]
        bg = torch.tensor([0.2, 0.4, 0.6], device=device, requires_grad=True)
        o = rasterize(*args, torch.ones(n, dtype=torch.bool, device=device), cam, (H, W), bg, s)
        assert int(o["n_dropped"]) == 0
        loss = (o["img"] ** 2).sum() + o["depth"].sum() + (o["mask"] * 0.5).sum()
        return [g.cpu() for g in torch.autograd.grad(loss, args + [bg])]

    fwd = kn.composite_pairs_fwd_rg if pair_major else kn.composite_tiles_fwd_cm
    bwd = kn.composite_pairs_bwd_rg if pair_major else kn.composite_tiles_bwd_cm
    n_f, n_b = fwd.launches, bwd.launches
    got = grads(dev)
    assert (fwd.launches, bwd.launches) == (n_f + 1, n_b + 1)
    for g, w in zip(got, grads("cpu")):
        assert _scaled(g, w) <= 1e-4


def test_failed_build_raises(dev, tmp_path, monkeypatch):
    from exavatar_release_tpu_torch import cuda_build

    bad = tmp_path / "broken.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setitem(cuda_build.LIBRARIES, "broken", (str(bad),))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.load("broken")
