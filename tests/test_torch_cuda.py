"""The port's CUDA kernels on the card: the compositing kernels forward and
backward, channel-major, pair-major and row-major, the stage probes and the
window build, each against its plain PyTorch version
on the same CUDA tensors; the wrappers' input checks, their launch counters,
a render's gradients against the same render on CPU tensors, a failed
build, and the binnings' pair expansion against its plain version. Marked ``cuda``; skips
where there is no GPU.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with PyTorch alone (tests/conftest.py imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import os.path as osp
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from torch_windows import ragged, windows

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
import chip_smoke  # noqa: E402  (the cull's model, pair_cull_stats)

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


def _pair_windows(rng, case, T=6, nx=3, K=700, tile=TILE):
    """Windows for the pair-major kernels' warp cull (8 x 8 pixel patches):
    ``small``, Gaussians of sigma 0.3-2 px, far smaller than a patch;
    ``edges``, centers on the patch and tile borders (x and y multiples of
    8, and the tile's own edges), so boxes straddle them; ``counts``, tiles
    of 1, 255, 257, 300, 513 and 700 rows, none a multiple of 256."""
    th, tw = tile
    t = np.arange(T)
    origins = np.stack([(t % nx) * tw, (t // nx) * th], 1).astype(np.float32)
    u = lambda: rng.uniform(size=(T, K))
    lo, span = (0.3, 1.7) if case == "small" else (0.5, 3.0)
    sx, sy = lo + span * u(), lo + span * u()
    rho = 1.8 * u() - 0.9
    gx = origins[:, :1] - 4 + (tw + 8) * u()
    gy = origins[:, 1:] - 4 + (th + 8) * u()
    if case == "edges":
        gx = origins[:, :1] + 8.0 * rng.integers(0, tw // 8 + 1, (T, K)) - 0.5 + 0.02 * u()
        gy = origins[:, 1:] + 8.0 * rng.integers(0, th // 8 + 1, (T, K)) - 0.5 + 0.02 * u()
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    log_op = np.log(0.02 + 0.98 * u())
    z = np.zeros((T, K))
    win = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det, gx, gy, log_op, z, z,
                    u(), u(), u(), 1 + 4 * u()], 1).astype(np.float32)
    counts = np.full(T, K, np.int32)
    if case == "counts":
        counts[:] = [1, 255, 257, 300, 513, 700]
        win[:, 5][np.arange(K)[None, :] >= counts[:, None]] = -1e9
    return win, counts, origins


def _pair_kernels_against_plain(dev, win, counts, origins, tile, nx, chunk):
    """Kernel 7 bit for bit and kernel 8 row by row against their plain
    versions on the ragged form of dense windows; returns the CUDA windows."""
    T = win.shape[0]
    rows, tid, flags = ragged(win, counts, chunk)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows, tid, flags = to(rows), to(tid), to(flags)
    bg = torch.tensor([1.0, 0.5, 0.25], device=dev)
    args = (rows, tid, flags, bg, 0.0, tile, T, chunk, nx)
    full = kn.composite_pairs_fwd_rg(*args)
    assert torch.equal(full, kn.composite_pairs_fwd_rg_plain(*args))
    g_full = torch.randn(full.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    bargs = (rows, tid, flags, bg, 0.0, full, g_full, tile, T, chunk, nx)
    got = kn.composite_pairs_bwd_rg(*bargs)
    assert _worst_row(got, kn.composite_pairs_bwd_rg_plain(*bargs), 0) <= 1e-4
    assert not got[:, rows[5] <= -1e9].any() and not got[:, -chunk:].any()
    return to(win), to(counts), to(origins), bg


@pytest.mark.parametrize("case", ["small", "edges", "counts"])
def test_pair_kernels_equal_plain_where_the_cull_bites(dev, case):
    """Where the per-warp cull and the exp gate skip most visits."""
    win, counts, origins = _pair_windows(np.random.default_rng(21), case)
    w, n, o, bg = _pair_kernels_against_plain(dev, win, counts, origins, TILE, 3, 256)
    # the cull does skip rows here: most (warp, row) pairs the warps reach
    _, visits = kn.composite_plain_with_visits(w, n, o, bg, TILE)
    st = chip_smoke.pair_cull_stats(w, n, o, TILE, visits)
    assert st.warp_rows_culled > st.warp_rows // 2


def test_pair_kernels_past_65535_tiles(dev):
    """More tiles than a grid's y dimension holds: 66,000 tiles of 8 x 8."""
    win, counts, origins = _pair_windows(np.random.default_rng(22), "small", T=66_000, nx=300,
                                         K=12, tile=(8, 8))
    _pair_kernels_against_plain(dev, win, counts, origins, (8, 8), 300, 16)


def _dense_kernels_against_plain(dev, win, counts, origins, tile):
    """Kernel 1 bit for bit and kernel 2 row by row against their plain
    versions on dense windows; kernel 2's channels 6-7 (in ``_worst_row``)
    and its slots at or past each tile's count exactly zero."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    win, counts, origins = to(win), to(counts), to(origins)
    bg = torch.tensor([1.0, 0.5, 0.25], device=dev)
    args = (win, counts, origins, bg, tile)
    full = kn.composite_tiles_fwd_cm(*args)
    assert torch.equal(full, kn.composite_tiles_fwd_cm_plain(*args))
    g_full = torch.randn(full.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    bargs = (win, counts, origins, bg, full, g_full, tile)
    got = kn.composite_tiles_bwd_cm(*bargs)
    assert _worst_row(got, kn.composite_tiles_bwd_cm_plain(*bargs), 1) <= 1e-4
    past = torch.arange(win.shape[2], device=dev)[None, :] >= counts[:, None]
    assert not got.permute(0, 2, 1)[past].any()


@pytest.mark.parametrize("case", ["small", "edges", "counts", "truncated", "off_grid"])
def test_dense_kernels_equal_plain_where_the_cull_bites(dev, case):
    """The dense kernels on the pair-major cases' windows, and on what only
    dense windows hold: counts above K (the kernels read min(count, K) rows)
    beside an empty tile, and origins off the tile grid (half a pixel and a
    band offset)."""
    rng = np.random.default_rng(23)
    win, counts, origins = _pair_windows(rng, case if case in ("small", "edges", "counts")
                                         else "small")
    K = win.shape[2]
    if case == "truncated":
        counts[:] = [K + 1, 3 * K, K, 0, 300, K + 7]
    elif case == "off_grid":
        shift = np.asarray([0.5, 1045.25], np.float32)
        origins += shift
        win[:, 3:5] += shift[None, :, None]
    _dense_kernels_against_plain(dev, win, counts, origins, TILE)


def test_dense_kernels_past_65535_tiles(dev):
    """The dense kernels' one-dimensional grid: 66,000 tiles of 8 x 8."""
    win, counts, origins = _pair_windows(np.random.default_rng(24), "small", T=66_000, nx=300,
                                         K=12, tile=(8, 8))
    _dense_kernels_against_plain(dev, win, counts, origins, (8, 8))


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


# --------------------------------------------------------------------------
# the row-major kernels (3-6, on the pair bodies of csrc/composite.cu and
# csrc/composite_bwd.cu)
# --------------------------------------------------------------------------


def _v2_kernels_against_plain(dev, win, counts, origins, tile):
    """Kernel 3 bit for bit and kernel 4 row by row against their plain
    versions on dense windows packed at their tiles' origins
    (``pack_tile_quads``); kernel 4's lanes 6-7 (in ``_worst_row``) and its
    slots at or past each tile's count exactly zero. Returns the packed
    rows, the counts and the plain version's visits per pixel."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    win, counts, origins = to(win), to(counts), to(origins)
    _, packed, color = chip_smoke.rm_rows_from_windows(win, origins)
    args = (packed, color, counts, tile)
    accum, tfinal = kn.composite_tiles_fwd_v2(*args)
    w_accum, w_tfinal, visits = kn.composite_rm_plain_with_visits(*args)
    assert torch.equal(accum, w_accum) and torch.equal(tfinal, w_tfinal)
    T, P = accum.shape[:2]
    g = torch.Generator().manual_seed(7)
    cot = (torch.randn(T, P, 4, generator=g).to(dev), torch.randn(T, P, 1, generator=g).to(dev))
    bargs = (packed, color, counts, *cot, accum, tfinal, tile)
    got = kn.composite_tiles_bwd_v2(*bargs)
    want = kn.composite_tiles_bwd_v2_plain(*bargs)
    assert _worst_row(torch.cat(got, dim=2), torch.cat(want, dim=2), 2) <= 1e-4
    past = torch.arange(packed.shape[1], device=dev)[None, :] >= counts[:, None]
    assert not got[0][past].any() and not got[1][past].any()
    return packed, counts, visits


@pytest.mark.parametrize("case", ["small", "edges", "counts", "truncated", "tile_20x36"])
def test_v2_kernels_equal_plain_where_the_cull_bites(dev, case):
    """Kernels 3 and 4 (``kernel_v=2``, the pair bodies on packed rows with
    tile-local boxes) on the pair-major cases' windows, on counts above K
    beside an empty tile, and on 20 x 36 tiles, not a multiple of the 8 x 8
    patch."""
    rng = np.random.default_rng(25)
    tile = (20, 36) if case == "tile_20x36" else TILE
    win, counts, origins = _pair_windows(rng, case if case in ("small", "edges", "counts")
                                         else "small", tile=tile)
    K = win.shape[2]
    if case == "truncated":
        counts[:] = [K + 1, 3 * K, K, 0, 300, K + 7]
    packed, n, visits = _v2_kernels_against_plain(dev, win, counts, origins, tile)
    # the packed cull does skip rows here: most (warp, row) pairs the warps reach
    st = chip_smoke.pair_cull_stats(packed, n, None, tile, visits)
    assert st.warp_rows_culled > st.warp_rows // 2


def test_v2_kernels_past_65535_tiles(dev):
    """Kernels 3 and 4's one-dimensional grid: 66,000 tiles of 8 x 8."""
    win, counts, origins = _pair_windows(np.random.default_rng(26), "small", T=66_000, nx=300,
                                         K=12, tile=(8, 8))
    _v2_kernels_against_plain(dev, win, counts, origins, (8, 8))


def _rm_kernels_against_plain(dev, win, counts, origins, tile):
    """Kernel 5 bit for bit and kernel 6 row by row against their plain
    versions on dense windows as global conic rows with origins; kernel 6's
    lanes 6-7 (in ``_worst_row``) and its slots at or past each tile's count
    exactly zero. Returns the rows, the counts, the origins and the plain
    version's visits per pixel."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    win, counts, origins = to(win), to(counts), to(origins)
    rows_g, _, color = chip_smoke.rm_rows_from_windows(win, origins)
    args = (rows_g, color, counts, tile)
    n5, n6 = kn.composite_tiles_fwd.launches, kn.composite_tiles_bwd.launches
    accum, tfinal = kn.composite_tiles_fwd(*args, origins)
    w_accum, w_tfinal, visits = kn.composite_rm_plain_with_visits(*args, origins)
    assert torch.equal(accum, w_accum) and torch.equal(tfinal, w_tfinal)
    T, P = accum.shape[:2]
    g = torch.Generator().manual_seed(8)
    cot = (torch.randn(T, P, 4, generator=g).to(dev), torch.randn(T, P, 1, generator=g).to(dev))
    bargs = (rows_g, color, counts, *cot, accum, tfinal, tile, origins)
    got = kn.composite_tiles_bwd(*bargs)
    want = kn.composite_tiles_bwd_plain(*bargs)
    assert (kn.composite_tiles_fwd.launches, kn.composite_tiles_bwd.launches) == (n5 + 1, n6 + 1)
    assert _worst_row(torch.cat(got, dim=2), torch.cat(want, dim=2), 2) <= 1e-4
    past = torch.arange(rows_g.shape[1], device=dev)[None, :] >= counts[:, None]
    assert not got[0][past].any() and not got[1][past].any()
    return rows_g, counts, origins, visits


@pytest.mark.parametrize("case", ["small", "edges", "counts", "truncated", "off_grid",
                                  "tile_20x36"])
def test_rm_kernels_equal_plain_where_the_cull_bites(dev, case):
    """Kernels 5 and 6 (the pair bodies on global conic rows with origins)
    on the pair-major cases' windows, on counts above K beside an empty
    tile, on origins off the tile grid (half a pixel and a band offset:
    the kernels take each tile's origin as given) and on 20 x 36 tiles, not
    a multiple of the 8 x 8 patch."""
    rng = np.random.default_rng(27)
    tile = (20, 36) if case == "tile_20x36" else TILE
    win, counts, origins = _pair_windows(rng, case if case in ("small", "edges", "counts")
                                         else "small", tile=tile)
    K = win.shape[2]
    if case == "truncated":
        counts[:] = [K + 1, 3 * K, K, 0, 300, K + 7]
    elif case == "off_grid":
        shift = np.asarray([0.5, 1045.25], np.float32)
        origins += shift
        win[:, 3:5] += shift[None, :, None]
    rows_g, n, o, visits = _rm_kernels_against_plain(dev, win, counts, origins, tile)
    # the cull does skip rows here: most (warp, row) pairs the warps reach
    st = chip_smoke.pair_cull_stats(rows_g.transpose(1, 2), n, o, tile, visits)
    assert st.warp_rows_culled > st.warp_rows // 2


def test_rm_kernels_past_65535_tiles(dev):
    """Kernels 5 and 6's one-dimensional grid: 66,000 tiles of 8 x 8."""
    win, counts, origins = _pair_windows(np.random.default_rng(28), "small", T=66_000, nx=300,
                                         K=12, tile=(8, 8))
    _rm_kernels_against_plain(dev, win, counts, origins, (8, 8))


@pytest.fixture(scope="module")
def rm_scene(scene):
    """The same windows row-major: global conic rows, their packed tile-local
    coefficients, colors, and both cotangents."""
    from exavatar_release_tpu_torch.ops.rasterizer.preprocess import pack_tile_quads

    s = scene
    rows_g = s["win"][:, :8].transpose(1, 2).contiguous()
    color = s["win"][:, 8:].transpose(1, 2).contiguous()
    packed = pack_tile_quads(rows_g, s["origins"][:, None, :]).contiguous()
    g = torch.Generator().manual_seed(4)
    P = TILE[0] * TILE[1]
    T = rows_g.shape[0]
    return dict(rows_g=rows_g, packed=packed, color=color, counts=s["counts"],
                origins=s["origins"],
                g_accum=torch.randn(T, P, 4, generator=g).to(rows_g.device),
                g_tfinal=torch.randn(T, P, 1, generator=g).to(rows_g.device))


RM_CASES = {"v2": ("packed", False), "v1": ("packed", False), "v1_origins": ("rows_g", True)}


def _rm_forward(r, case, plain=False):
    quad, localize = RM_CASES[case]
    args = (r[quad], r["color"], r["counts"], TILE)
    if case == "v2":
        return (kn.composite_tiles_fwd_v2_plain if plain else kn.composite_tiles_fwd_v2)(*args)
    fn = kn.composite_tiles_fwd_plain if plain else kn.composite_tiles_fwd
    return fn(*args, r["origins"] if localize else None)


@pytest.mark.parametrize("case", list(RM_CASES))
def test_row_major_fwd_kernel_equals_plain(rm_scene, case):
    wrapper = kn.composite_tiles_fwd_v2 if case == "v2" else kn.composite_tiles_fwd
    n = wrapper.launches
    accum, tfinal = _rm_forward(rm_scene, case)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    w_accum, w_tfinal = _rm_forward(rm_scene, case, plain=True)
    # the kernel rounds every operation as the plain version does (-fmad=false)
    assert torch.equal(accum, w_accum) and torch.equal(tfinal, w_tfinal)
    assert float(tfinal.min()) < 2e-4  # some pixels terminated


def test_row_major_localized_is_the_channel_major_function(scene, rm_scene):
    s = scene
    accum, tfinal = _rm_forward(rm_scene, "v1_origins")
    full = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    mine = torch.cat([accum[..., :3] + tfinal * s["bg"], accum[..., 3:4], 1 - tfinal], dim=2)
    assert float((full - mine.transpose(1, 2)).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", list(RM_CASES))
def test_row_major_bwd_kernel_vs_plain(rm_scene, case):
    r = rm_scene
    quad, localize = RM_CASES[case]
    accum, tfinal = _rm_forward(r, case)
    args = (r[quad], r["color"], r["counts"], r["g_accum"], r["g_tfinal"], accum, tfinal, TILE)
    if case == "v2":
        wrapper = kn.composite_tiles_bwd_v2
        n = wrapper.launches
        got = wrapper(*args)
        want = kn.composite_tiles_bwd_v2_plain(*args)
    else:
        wrapper = kn.composite_tiles_bwd
        n = wrapper.launches
        o = r["origins"] if localize else None
        got = wrapper(*args, o)
        want = kn.composite_tiles_bwd_plain(*args, o)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    # [dquad | dcolor] has the layout of the channel-major rows: lanes 6-7 zero
    assert _worst_row(torch.cat(got, dim=2), torch.cat(want, dim=2), 2) <= 1e-4
    past = torch.arange(got[0].shape[1], device=got[0].device)[None, :] >= r["counts"][:, None]
    assert not got[0][past].any() and not got[1][past].any()


@pytest.mark.parametrize("bad", ["dtype", "strided", "shape", "misaligned"])
def test_row_major_wrapper_rejects(rm_scene, bad):
    r = dict(rm_scene)
    if bad == "dtype":
        r["packed"] = r["packed"].double()
    elif bad == "strided":
        r["packed"] = r["packed"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        r["color"] = r["color"][..., :3].contiguous()
    else:
        flat = torch.zeros(r["packed"].numel() + 1, device=r["packed"].device)
        flat[1:] = r["packed"].reshape(-1)
        r["packed"] = flat[1:].reshape(r["packed"].shape)
    with pytest.raises((TypeError, ValueError)):
        kn.composite_tiles_fwd_v2(r["packed"], r["color"], r["counts"], TILE)


def test_render_kernel_v2_card_vs_cpu(dev):
    """``rasterize(kernel_v=2)``: the row-major kernels on the card against
    their plain versions on CPU tensors; one v2 forward and one v2 backward
    launch, one pair expansion (the compact binning), none of the other
    kernels."""
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize

    rng = np.random.default_rng(6)
    n, H, W, f = 400, 96, 256, 150.0
    z = rng.uniform(2.0, 4.0, (n, 1))
    d = dict(
        means3d=np.concatenate([rng.uniform(-0.5, 0.5, (n, 1)) * (W / f) * z,
                                rng.uniform(-0.5, 0.5, (n, 1)) * (H / f) * z, z], 1),
        scales=np.exp(rng.uniform(np.log(0.02), np.log(0.1), (n, 3))),
        quats=rng.normal(size=(n, 4)), opacities=rng.uniform(0.3, 0.95, (n, 1)),
        rgbs=rng.uniform(0, 1, (n, 3)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    s = RasterizeSettings(tile_h=32, tile_w=128, max_per_tile=512, kernel_v=2)

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

    before = {k: k.launches for k in kn.KERNELS}
    got = grads(dev)
    after = {k.__name__: k.launches - before[k] for k in kn.KERNELS}
    used = (kn.composite_tiles_fwd_v2, kn.composite_tiles_bwd_v2, kn.expand_pairs)
    assert after == {k.__name__: int(k in used) for k in kn.KERNELS}
    # The packing's transpose forms d/d(gx) as A (sum dq lx - gx sum dq) + ...:
    # sums of size |dq| * 128 px cancel down to |dq| * a few px, and the conic's
    # gradient cancels twice, so the last-bit differences between the kernel's
    # atomic sums and the plain version's come out some 1e3 times larger in
    # the inputs' gradients. The tolerance is the one the JAX package holds its
    # own kernel_v=2 to (tests/test_rasterizer.py, test_kernel_v2_matches_v1):
    # 5e-4 of the leaf's largest value plus 2e-3 relative.
    for g, w in zip(got, grads("cpu")):
        scale = max(1e-3, float(w.abs().max()))
        assert bool(((g - w).abs() <= 5e-4 * scale + 2e-3 * w.abs()).all())


@pytest.mark.parametrize("pair_major", [False, True], ids=["dense", "pair_major"])
def test_band_render_on_a_local_mesh_of_the_card(dev, pair_major):
    """``rasterize_sharded`` and ``rasterize_gaussian_sharded`` over four row
    bands on a local mesh of the card (kernels 1/2 or 7/8 at the bands'
    global row offsets) against the single-device render through the same
    kernels: outputs within TOL of chip_smoke (bit-equal in practice: the
    bands' tiles and windows are the single render's), input gradients
    within 1e-4 of each column's largest value (the pair sums' atomics and
    the bands' separate gathers sum in other orders)."""
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize
    from exavatar_release_tpu_torch.parallel import (
        make_mesh, rasterize_gaussian_sharded, rasterize_sharded)

    rng = np.random.default_rng(8)
    n, H, W, f = 600, 200, 384, 150.0
    z = rng.uniform(2.0, 4.0, (n, 1))
    d = dict(
        means3d=np.concatenate([rng.uniform(-0.5, 0.5, (n, 1)) * (W / f) * z,
                                rng.uniform(-0.5, 0.5, (n, 1)) * (H / f) * z, z], 1),
        scales=np.exp(rng.uniform(np.log(0.02), np.log(0.1), (n, 3))),
        quats=rng.normal(size=(n, 4)), opacities=rng.uniform(0.3, 0.95, (n, 1)),
        rgbs=rng.uniform(0, 1, (n, 3)))
    d = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in d.items()}
    cam = Camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                 torch.tensor([f, f], device=dev), torch.tensor([W / 2.0, H / 2.0], device=dev))
    s = RasterizeSettings(max_per_tile=1024, pair_major=pair_major)
    mesh = make_mesh((4,), ("tile",), [dev] * 4)
    live, bg = torch.ones(n, dtype=torch.bool, device=dev), torch.tensor([0.2, 0.4, 0.6],
                                                                          device=dev)

    def run(render):
        args = [v.clone().requires_grad_(True) for v in d.values()]
        o = render(*args, live, cam, (H, W), bg)
        assert int(o["n_dropped"]) == 0
        loss = (o["img"] ** 2).sum() + o["depth"].sum() + (o["mask"] * 0.5).sum()
        return o, torch.autograd.grad(loss, args)

    want, g_want = run(lambda *a: rasterize(*a, s))
    used = (("composite_pairs_fwd_rg", "composite_pairs_bwd_rg", "expand_pairs", "chunk_slots")
            if pair_major else ("composite_tiles_fwd_cm", "composite_tiles_bwd_cm"))
    for fn in (rasterize_sharded, rasterize_gaussian_sharded):
        before = {k: k.launches for k in kn.KERNELS}
        got, g_got = run(lambda *a: fn(*a, mesh, "tile", s))
        torch.cuda.synchronize()
        # one forward and one backward launch for each of the four bands,
        # and pair-major one pair expansion and one chunk-slot launch (the
        # dense bands bin with bin_gaussians_sorted)
        made = {k.__name__: k.launches - before[k] for k in kn.KERNELS}
        assert made == {k: 4 if k in used else 0 for k in made}, (fn.__name__, made)
        for k, tol in chip_smoke.TOL.items():
            assert float((got[k] - want[k]).abs().max()) <= tol, (fn.__name__, k)
        if fn is rasterize_gaussian_sharded:
            assert int(got["exchange_overflow"].sum()) == 0
        assert chip_smoke.input_grad_cols(g_got, g_want) <= chip_smoke.GRAD_TOL, fn.__name__


def test_failed_build_raises(dev, tmp_path, monkeypatch):
    from exavatar_release_tpu_torch import cuda_build

    bad = tmp_path / "broken.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setitem(cuda_build.LIBRARIES, "broken", (str(bad),))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.load("broken")


# --------------------------------------------------------------------------
# the probe kernels: the stage probes, kernels 5 and 6's pair bodies under
# each variant's hooks (csrc/composite_probes.cuh), and the window build
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def probe_rows(scene):
    """The scene's windows as global conic rows with origins, opaque enough
    that pixels end inside the first 256-row batch, and the base forward."""
    s = scene
    quad = s["win"][:, :8].transpose(1, 2).contiguous()
    quad[..., 5] = torch.where(quad[..., 5] > -1e8, quad[..., 5] * 0.25, quad[..., 5])
    color = s["win"][:, 8:].transpose(1, 2).contiguous()
    g = torch.Generator().manual_seed(9)
    P = TILE[0] * TILE[1]
    cot = (torch.randn(16, P, 4, generator=g).to(quad.device),
           torch.randn(16, P, 1, generator=g).to(quad.device))
    fwd = kn.composite_tiles_fwd(quad, color, s["counts"], TILE, s["origins"])
    return dict(quad=quad, color=color, counts=s["counts"], origins=s["origins"], cot=cot,
                fwd=fwd)


def _rows_err(got, want):
    """Worst ratio over the used rows (lanes 0-5 of dquad, 0-3 of dcolor) of
    max |got - want| to the row's own max |want|."""
    worst = 0.0
    for g, w, lanes in ((got[0], want[0], range(6)), (got[1], want[1], range(4))):
        for c in lanes:
            scale = float(w[..., c].abs().max())
            err = float((g[..., c] - w[..., c]).abs().max())
            worst = max(worst, err / scale if scale > 0 else (0.0 if err == 0 else np.inf))
    return worst


@pytest.mark.parametrize("variant", kn.FWD_VARIANTS)
def test_fwd_variant_equals_plain(probe_rows, variant):
    r = probe_rows
    args = (r["quad"], r["color"], r["counts"], TILE, r["origins"])
    # every variant, base included, launches the probes' own kernel and
    # counts there; kernel 5 is not launched
    before = (kn.composite_tiles_fwd_variant.launches, kn.composite_tiles_fwd.launches)
    got = kn.composite_tiles_fwd_variant(variant, *args)
    want = kn.composite_tiles_fwd_variant_plain(variant, *args)
    torch.cuda.synchronize()
    assert (kn.composite_tiles_fwd_variant.launches, kn.composite_tiles_fwd.launches) == (
        before[0] + 1, before[1])
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    if variant == "base":
        # kernel 5's pair body launched as a probe, bit for bit
        assert all(torch.equal(g, w) for g, w in zip(got, r["fwd"]))
        # the probes' entry point at variant 0 launches the same kernel
        direct = kn._fwd_rm(kn.composite_tiles_fwd_variant, *args, kn.VARIANT_IDS["base"])
        assert all(torch.equal(g, w) for g, w in zip(direct, got))
    if variant in kn.EXACT_VARIANTS:
        for g, w in zip(got, r["fwd"]):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("variant", kn.BWD_VARIANTS)
def test_bwd_variant_equals_plain(probe_rows, variant):
    r = probe_rows
    args = (r["quad"], r["color"], r["counts"], *r["cot"], *r["fwd"], TILE, r["origins"])
    before = (kn.composite_tiles_bwd_variant.launches, kn.composite_tiles_bwd.launches)
    got = kn.composite_tiles_bwd_variant(variant, *args)
    want = kn.composite_tiles_bwd_variant_plain(variant, *args)
    torch.cuda.synchronize()
    assert (kn.composite_tiles_bwd_variant.launches, kn.composite_tiles_bwd.launches) == (
        before[0] + 1, before[1])
    assert not got[0][..., 6:].any()
    if variant == "nograd":
        assert not got[0].any() and not got[1].any()
        return
    assert _rows_err(got, want) <= 1e-4
    if variant == "base" or variant in kn.EXACT_VARIANTS:
        b6 = kn.composite_tiles_bwd(r["quad"], r["color"], r["counts"], *r["cot"], *r["fwd"],
                                    TILE, r["origins"])
        # base against kernel 6: the same code, whose atomics sum in an order
        # that changes from run to run
        assert _rows_err(got, b6) <= (1e-6 if variant == "base" else 1e-4)


def test_variant_checks(probe_rows):
    r = probe_rows
    with pytest.raises(ValueError):
        kn.composite_tiles_fwd_variant("nograd", r["quad"], r["color"], r["counts"], TILE,
                                       r["origins"])
    with pytest.raises(ValueError):
        kn.composite_tiles_fwd_variant("base", r["quad"], r["color"], r["counts"], TILE, None)


@pytest.mark.parametrize("case", ["small", "edges", "counts", "truncated", "off_grid",
                                  "tile_20x36", "chunk_edge"])
def test_variants_where_the_cull_bites(dev, case):
    """Every stage probe on kernels 5 and 6's cull cases
    (``test_rm_kernels_equal_plain_where_the_cull_bites``) and on windows
    where the cull meets the chunk forms' bookkeeping
    (``torch_windows.chunk_edge_windows``: counts past one 256-row batch,
    each chunk's last row culled by all patches but one, opaque rows that
    end pixels inside the first chunk): each forward within 1e-5 of each
    output's max of its plain version and base bit-equal to kernel 5; each
    backward within 1e-4 of each row's max of its plain version, lanes 6-7
    zero, nograd all zero, and base within 1e-6 of kernel 6's rows."""
    from torch_windows import chunk_edge_windows

    rng = np.random.default_rng(29)
    tile = (20, 36) if case == "tile_20x36" else TILE
    if case == "chunk_edge":
        win, counts, origins = chunk_edge_windows(rng, T=4, tile_shape=tile)
    else:
        win, counts, origins = _pair_windows(rng, case if case in ("small", "edges", "counts")
                                             else "small", tile=tile)
        K = win.shape[2]
        if case == "truncated":
            counts[:] = [K + 1, 3 * K, K, 0, 300, K + 7]
        elif case == "off_grid":
            shift = np.asarray([0.5, 1045.25], np.float32)
            origins += shift
            win[:, 3:5] += shift[None, :, None]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    win, counts, origins = to(win), to(counts), to(origins)
    rows_g, _, color = chip_smoke.rm_rows_from_windows(win, origins)
    args = (rows_g, color, counts, tile, origins)
    f5 = kn.composite_tiles_fwd(*args)
    T, P = f5[0].shape[:2]
    g = torch.Generator().manual_seed(30)
    cot = (torch.randn(T, P, 4, generator=g).to(dev), torch.randn(T, P, 1, generator=g).to(dev))
    bargs = (rows_g, color, counts, *cot, *f5, tile, origins)
    b6 = kn.composite_tiles_bwd(*bargs)
    bad = []
    for v in kn.FWD_VARIANTS:
        got = kn.composite_tiles_fwd_variant(v, *args)
        want = kn.composite_tiles_fwd_variant_plain(v, *args)
        err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
        if err > 1e-5 or (v == "base" and not all(map(torch.equal, got, f5))):
            bad.append((f"fwd/{v}", err))
    for v in kn.BWD_VARIANTS:
        got = kn.composite_tiles_bwd_variant(v, *bargs)
        if v == "nograd":
            err = float(max(got[0].abs().max(), got[1].abs().max()))
            ok = err == 0.0
        else:
            err = _rows_err(got, kn.composite_tiles_bwd_variant_plain(v, *bargs))
            ok = err <= 1e-4 and not got[0][..., 6:].any()
            if v == "base":
                ok &= _rows_err(got, b6) <= 1e-6
        if not ok:
            bad.append((f"bwd/{v}", err))
    assert not bad, bad


def test_tile_windows_equals_gather(dev):
    rng = np.random.default_rng(12)
    n, T, K, Pm = 5000, 300, 512, 90_000
    starts = np.sort(rng.integers(0, Pm, T + 1)).astype(np.int32)
    starts[0], starts[-1] = 0, Pm
    starts[7] = starts[8]
    rank = torch.from_numpy(rng.integers(0, n, Pm).astype(np.int32)).to(dev)
    st = torch.from_numpy(starts).to(dev)
    before = kn.tile_windows.launches
    got = kn.tile_windows(st, rank, K, n)
    torch.cuda.synchronize()
    assert kn.tile_windows.launches == before + 1
    assert torch.equal(got, kn.tile_windows_plain(st, rank, K, n))
    assert (got[7] == n).all()
    with pytest.raises(TypeError):
        kn.tile_windows(st.long(), rank, K, n)
    # a 16-byte vector across rows (K = 1, 7, 1023), empty first, middle and
    # last tiles, counts above K, rank exactly starts[T] long
    for name, st, rank, K, n in chip_smoke.window_edge_cases(dev):
        got = kn.tile_windows(st, rank, K, n)
        torch.cuda.synchronize()
        assert torch.equal(got, kn.tile_windows_plain(st, rank, K, n)), name
        if int(st[1]) == 0:  # an empty first tile
            assert (got[0] == n).all(), name
    assert kn.tile_windows(st[:1], rank, 4, 1).shape == (0, 4)
    assert kn.tile_windows(st, rank, 0, 1).shape == (st.shape[0] - 1, 0)


def test_tile_windows_past_2_31_entries(dev):
    """T K > 2^31 takes 64-bit offsets: the last rows against the plain
    version on those rows, with rows a multiple of 16 bytes long and not
    (K = 2^14 + 3: vectors cross rows, T K % 4 != 0)."""
    T, n = (1 << 17) + 1, 7
    for K in (1 << 14, (1 << 14) + 3):
        counts = torch.full((T,), 5, dtype=torch.int64, device=dev)
        counts[-1], counts[-2] = K + 3, 0
        starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int()
        rank = torch.arange(int(starts[-1]), dtype=torch.int32, device=dev) % 1000
        got = kn.tile_windows(starts, rank, K, n)
        torch.cuda.synchronize()
        assert T * K > 1 << 31
        last = starts[-9:] - starts[-9]
        want = kn.tile_windows_plain(last, rank[int(starts[-9]):], K, n)
        assert torch.equal(got[-8:], want), K
        assert torch.equal(got[:4, :6], kn.tile_windows_plain(starts[:5], rank, 6, n)), K
        del got


# --------------------------------------------------------------------------
# the binnings' pair expansion and chunk slots (csrc/binning.cu)
# --------------------------------------------------------------------------

# case: (binning, Gaussians, image, tile, pair budget (0: 16 per Gaussian),
# chunk, tile-row offset)
EXPAND_CASES = {
    "ample": ("compact", 3000, (1080, 1920), (32, 128), 0, 0, 0),
    "cut_mid_segment": ("compact", 3000, (1080, 1920), (32, 128), 2999, 0, 0),
    "zero_span_between": ("compact", 3000, (1080, 1920), (32, 128), 0, 0, 0),
    "all_invisible": ("compact", 500, (1080, 1920), (32, 128), 0, 0, 0),
    "n1": ("compact", 1, (1080, 1920), (32, 128), 0, 0, 0),
    "pm_not_block_multiple": ("compact", 2000, (1080, 1920), (32, 128), 256 * 37 + 41, 0, 0),
    "band": ("ragged", 3000, (270, 1920), (32, 128), 0, 256, 3),
    "chunk128": ("ragged", 3000, (1080, 1920), (32, 128), 0, 128, 0),
    "chunk256": ("ragged", 3000, (1080, 1920), (32, 128), 0, 256, 0),
    "main_shape": ("ragged", 164_379, (1080, 1920), (32, 128), 0, 256, 0),
}


def _expand_screen(case, n, img, y0, dev):
    """Seeded screen-space inputs: means over and around the image, whose
    first row is the global row y0, radii of 0.5-120 px, tight extents
    below them."""
    rng = np.random.default_rng(sum(map(ord, case)))
    H, W = img
    mean2d = rng.uniform([-100.0, y0 - 100.0], [W + 100.0, y0 + H + 100.0], (n, 2))
    radius = np.ceil(np.exp(rng.uniform(np.log(0.5), np.log(120.0), n)))
    extent = radius[:, None] * rng.uniform(0.3, 1.0, (n, 2))
    visible = rng.uniform(size=n) > 0.1
    if case == "zero_span_between":
        radius[rng.uniform(size=n) < 0.3] = 0.0
        visible &= rng.uniform(size=n) > 0.2
    if case == "all_invisible":
        visible[:] = False
    to = lambda a, t: torch.from_numpy(np.ascontiguousarray(a)).to(dev, t)
    return (to(mean2d, torch.float32), to(radius, torch.float32),
            to(rng.uniform(0.5, 9.0, n), torch.float32), to(visible, torch.bool),
            to(extent, torch.float32))


@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_pairs_equals_plain(dev, case, monkeypatch):
    """Every launch a card binning makes, of ``expand_pairs`` and (ragged)
    ``chunk_slots``, bit for bit against the plain version on the same CUDA
    tensors; and the binning's integers against the same binning on CPU
    tensors."""
    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm

    kind, n, img, tile, max_pairs, chunk, row_offset = EXPAND_CASES[case]
    mean2d, radius, depth, visible, extent = _expand_screen(case, n, img, row_offset * tile[0],
                                                            dev)
    calls = []

    def recorder(name):
        def record(*args):
            out = getattr(kn, name)(*args)
            calls.append((name, args, out))
            return out
        return record

    monkeypatch.setattr(bnm, "kernels", SimpleNamespace(
        expand_pairs=recorder("expand_pairs"), chunk_slots=recorder("chunk_slots")))
    budget = max_pairs or 16 * n
    if kind == "compact":
        fn = lambda m, r, d, v, e: bnm.bin_gaussians_compact(
            m, r, d, v, img, *tile, max_per_tile=1024, max_pairs=budget, extent=e)
    else:
        fn = lambda m, r, d, v, e: bnm.bin_gaussians_ragged(
            m, r, d, v, img, *tile, chunk=chunk, max_pairs=budget, extent=e,
            tile_row_offset=row_offset)
    got = fn(mean2d, radius, depth, visible, extent)
    torch.cuda.synchronize()
    assert [c[0] for c in calls] == (["expand_pairs"] + ["chunk_slots"] * (kind == "ragged"))
    for name, args, out in calls:
        want = getattr(kn, f"{name}_plain")(*args)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), name
    offsets, span = calls[0][1][:2]
    Pm = calls[0][1][-1]
    if case == "cut_mid_segment":  # a segment crosses the budget's end
        assert bool(((offsets < Pm) & (offsets + span > Pm)).any())
    if case == "all_invisible":
        assert int(span.sum()) == 0
    if case == "zero_span_between":
        live = (span > 0).nonzero()[:, 0]
        assert bool((span[int(live[0]):int(live[-1])] == 0).any())
    if case == "pm_not_block_multiple":
        assert Pm % 256
    monkeypatch.undo()
    want = fn(*(x.cpu() for x in (mean2d, radius, depth, visible, extent)))
    for f in got._fields:
        if f != "num_tiles":
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (case, f)


@pytest.mark.parametrize("pair_major", [False, True], ids=["dense", "pair_major"])
def test_expand_pairs_launches_once_per_prepare(dev, pair_major):
    """``api.prepare`` expands the pairs in one launch, dense or pair-major,
    and the pair-major binning lays out its chunk slots in one more."""
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, api

    rng = np.random.default_rng(9)
    n, H, W, f = 400, 96, 256, 150.0
    z = rng.uniform(2.0, 4.0, (n, 1))
    d = [np.concatenate([rng.uniform(-0.5, 0.5, (n, 1)) * (W / f) * z,
                         rng.uniform(-0.5, 0.5, (n, 1)) * (H / f) * z, z], 1),
         np.exp(rng.uniform(np.log(0.02), np.log(0.1), (n, 3))), rng.normal(size=(n, 4)),
         rng.uniform(0.3, 1.0, (n, 1)), rng.uniform(0, 1, (n, 3))]
    d = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in d]
    cam = Camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                 torch.tensor([f, f], device=dev), torch.tensor([W / 2.0, H / 2.0], device=dev))
    s = RasterizeSettings(max_per_tile=512, pair_major=pair_major)
    before = (kn.expand_pairs.launches, kn.chunk_slots.launches)
    with torch.no_grad():
        api.prepare(*d, torch.ones(n, dtype=torch.bool, device=dev), cam, (H, W), s)
    torch.cuda.synchronize()
    assert (kn.expand_pairs.launches - before[0], kn.chunk_slots.launches - before[1]) == (
        1, int(pair_major))
