"""The pair-major kernels' schedule on the CPU (csrc/composite.cu
``composite_pairs_range``, csrc/composite_bwd.cu ``composite_pairs_range_bwd``):
the per-warp row cull by ``kernels.row_pixel_box`` and the exp gate
``kernels.Q_GATE`` must change nothing, so the schedule's forward is the
plain version's bit for bit and its backward the plain version's up to the
order of its sums. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import math
import os.path as osp
import re
import sys

import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (seeded windows, ragged layout)

torch.set_num_threads(2)

LN255 = math.log(255.0)


# --------------------------------------------------------------------------
# (a) the box holds every pixel the plain version composites
# --------------------------------------------------------------------------


def _adversarial_rows(rng, n=240):
    """Rows (12, n): sigmas log-uniform over 0.3-300 px, correlations up to
    +-0.999, log-opacities within 1e-4 of -ln 255 for a third of them, and
    centers set so that the ellipse's exact x or y extreme falls within 1e-3
    px of a pixel for half of them."""
    sx, sy = np.exp(rng.uniform(np.log(0.3), np.log(300.0), (2, n)))
    rho = rng.uniform(-0.999, 0.999, n)
    rho[:8] = [0.999, -0.999] * 4
    log_op = np.log(rng.uniform(1.0 / 255.0, 1.0, n))
    near = rng.random(n) < 1.0 / 3.0
    log_op[near] = -LN255 + rng.uniform(-1e-4, 1e-4, near.sum())
    cov_det = (sx * sy) ** 2 * (1 - rho ** 2)
    A, B, C = sy ** 2 / cov_det, -rho * sx * sy / cov_det, sx ** 2 / cov_det
    gx, gy = rng.uniform(100.0, 1900.0, (2, n))
    # exact half-extents of the alpha >= 1/255 ellipse, in float64
    L = np.maximum(log_op + LN255, 0.0)
    ex, ey = np.sqrt(2 * L) * sx, np.sqrt(2 * L) * sy
    tangent = rng.random(n) < 0.5
    side = rng.integers(0, 4, n)
    d = rng.uniform(-1e-3, 1e-3, n)
    for i in np.flatnonzero(tangent):
        if side[i] < 2:
            edge = gx[i] + (ex[i] if side[i] == 0 else -ex[i])
            gx[i] += np.round(edge) - edge + d[i]
        else:
            edge = gy[i] + (ey[i] if side[i] == 2 else -ey[i])
            gy[i] += np.round(edge) - edge + d[i]
    z = np.zeros(n)
    return np.stack([A, B, C, gx, gy, log_op, z, z, z, z, z, z]).astype(np.float32)


def _composited(row, px, py):
    """The plain version's test of one row (12,) at pixels: q <= log_op and
    exp(q) >= 1/255, from ``_conic_q``'s float32 q."""
    q, log_op, _ = kn._conic_q(row[None, :6], px[None], py[None])
    return ((q <= log_op) & (torch.exp(q) >= kn.ALPHA_MIN))[0]


def _outside_pixels(box, pad=4, cap=6000):
    """Integer pixels in the pad-wide frame just outside a finite box."""
    xmin, xmax, ymin, ymax = box
    xs = torch.arange(math.floor(xmin) - pad, math.ceil(xmax) + pad + 1).float()[:cap]
    ys = torch.arange(math.floor(ymin) - pad, math.ceil(ymax) + pad + 1).float()[:cap]
    left = xs[(xs < xmin) & (xs >= xmin - pad)]
    right = xs[(xs > xmax) & (xs <= xmax + pad)]
    below = ys[(ys < ymin) & (ys >= ymin - pad)]
    above = ys[(ys > ymax) & (ys <= ymax + pad)]
    cols = torch.cat([left, right])
    rows = torch.cat([below, above])
    px = torch.cat([cols.repeat_interleave(len(ys)), xs.repeat(len(rows))])
    py = torch.cat([ys.repeat(len(cols)), rows.repeat_interleave(len(xs))])
    return px, py


def test_box_is_conservative():
    rows = torch.from_numpy(_adversarial_rows(np.random.default_rng(5)))
    # no positive-definite conic (B^2 > AC, AC = B^2, negative definite): the
    # whole plane
    bad = rows[:, :3].clone()
    bad[1, 0] = 1.5 * torch.sqrt(bad[0, 0] * bad[2, 0])
    bad[0:3, 1] = torch.tensor([1.0, 1.0, 1.0])
    bad[0:3, 2] = torch.tensor([-1.0, 0.0, -1.0])
    # the -1e9 padding rows
    pad = rows[:, :2].clone()
    pad[5] = -1e9
    every = torch.cat([rows, bad, pad], dim=1)
    box = kn.row_pixel_box(every)
    n, nb = rows.shape[1], bad.shape[1]
    assert torch.isinf(box[:, n:n + nb]).all() and (box[0, n:n + nb] < 0).all()
    assert (box[0, n + nb:] > box[1, n + nb:]).all()

    empty = finite = 0
    for i in range(every.shape[1]):
        b = box[:, i].tolist()
        if b[0] > b[1]:  # empty: no pixel near the center composites
            empty += 1
            cx, cy = round(float(every[3, i])), round(float(every[4, i]))
            g = torch.arange(-4, 5).float()
            px, py = (cx + g).repeat(9), (cy + g).repeat_interleave(9)
        elif math.isinf(b[0]):
            continue
        else:
            finite += 1
            px, py = _outside_pixels(b)
        hit = _composited(every[:, i], px, py)
        assert not hit.any(), (i, every[:6, i].tolist(), b, px[hit][:3], py[hit][:3])
    # the sample covers what it claims: near-threshold rows with empty boxes,
    # and boxes of every size
    assert empty >= 10 and finite >= 150
    ext = (box[1, :n] - box[0, :n])[box[1, :n] > box[0, :n]]
    assert float(ext.min()) < 3.0 and float(ext.max()) > 1000.0


def test_box_is_tight():
    """Not vacuous: for a well-shaped row (|rho| <= 0.8, sigmas >= 1 px, L >=
    0.5) some pixel on each side of the box, within 3 px + 2% of the
    half-extent of the edge, composites: the slack costs the cull little."""
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(_adversarial_rows(rng))
    A, B, C, log_op = rows[0].double(), rows[1].double(), rows[2].double(), rows[5].double()
    rho = -B / torch.sqrt(A * C)
    sx, sy = torch.sqrt(C / (A * C - B * B)), torch.sqrt(A / (A * C - B * B))
    box = kn.row_pixel_box(rows)
    ok = (rho.abs() <= 0.8) & (torch.minimum(sx, sy) >= 1.0) & (log_op + LN255 >= 0.5)
    checked = 0
    for i in np.flatnonzero(ok.numpy()):
        xmin, xmax, ymin, ymax = box[:, i].tolist()
        wx = 3.0 + 0.02 * (xmax - xmin) / 2
        wy = 3.0 + 0.02 * (ymax - ymin) / 2
        xs = torch.arange(math.floor(xmin), math.ceil(xmax) + 1).float()
        ys = torch.arange(math.floor(ymin), math.ceil(ymax) + 1).float()
        for edge_x in (xs[xs <= xmin + wx], xs[xs >= xmax - wx]):
            hit = _composited(rows[:, i], edge_x.repeat(len(ys)), ys.repeat_interleave(len(edge_x)))
            assert hit.any(), (i, "x", rows[:6, i].tolist(), box[:, i].tolist())
        for edge_y in (ys[ys <= ymin + wy], ys[ys >= ymax - wy]):
            hit = _composited(rows[:, i], xs.repeat(len(edge_y)), edge_y.repeat_interleave(len(xs)))
            assert hit.any(), (i, "y", rows[:6, i].tolist(), box[:, i].tolist())
        checked += 1
    assert checked >= 40


# --------------------------------------------------------------------------
# (b) the exp gate
# --------------------------------------------------------------------------


def _cuh_constants():
    text = open(osp.join(REPO, "exavatar_release_tpu_torch", "csrc", "composite_common.cuh")).read()
    return dict(re.findall(r"constexpr float (k\w+) = \(float\)([-+0-9.e]+);", text))


def test_gate_skips_only_what_reaches_skips():
    assert _cuh_constants()["kQGate"] == repr(kn.Q_GATE)
    gate = torch.tensor(kn.Q_GATE, dtype=torch.float32)
    assert float(gate) < -LN255
    # every float32 from Q_GATE down to -20, through their bit patterns
    lo = int(torch.tensor(-kn.Q_GATE, dtype=torch.float32).view(torch.int32))
    hi = int(torch.tensor(20.0).view(torch.int32))
    q = -torch.arange(lo, hi + 1, dtype=torch.int32).view(torch.float32)
    assert float(q[0]) == float(gate) and float(q[-1]) == -20.0 and len(q) > 10_000_000
    assert bool((torch.exp(q) < kn.ALPHA_MIN).all())


def test_box_constants_match_the_kernel():
    c = _cuh_constants()
    assert {k: float(v) for k, v in c.items() if k.startswith("kBox")} == {
        "kBoxLn255": kn.BOX_LN255, "kBoxMaxK": kn.BOX_MAX_K, "kBoxSlackK": kn.BOX_SLACK_K,
        "kBoxSlackAbs": kn.BOX_SLACK_ABS}
    assert float(torch.tensor(kn.BOX_LN255, dtype=torch.float32)) > LN255
    # the layout the schedule's mirror and chip_smoke.pair_cull_stats assume
    text = open(osp.join(REPO, "exavatar_release_tpu_torch", "csrc", "composite_common.cuh")).read()
    assert "constexpr int kPairsR = %d;" % chip_smoke.PAIRS_R in text
    assert "constexpr int kLanesW = %d, kLanesH = %d;" % (chip_smoke.LANES_W,
                                                          chip_smoke.LANES_H) in text
    assert "constexpr int kWarps = kBlock / 32;" in text and "constexpr int kBlock = 256;" in text
    assert chip_smoke.PAIR_WARPS == 256 // 32


# --------------------------------------------------------------------------
# (c) the schedule: two pixels a thread, the cull per warp patch, the gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [(32, 128), (8, 8), (20, 36), (16, 16)])
def test_pair_layout_places_each_pixel_once(tile):
    """chip_smoke.pair_layout as composite_common.cuh's pair_pixels lays it
    out: patch p at (p % npx, p / npx) patch widths, lane l at column l % 8
    and rows 2 (l / 8) + slot of it, every pixel once, inside its patch's
    bounds, and tiles of any size (padding past the tile in the patches)."""
    th, tw = tile
    lay = chip_smoke.pair_layout(tile)
    i = torch.arange(th * tw)
    x0, x1, y0, y1 = lay.bounds[lay.patch].T
    assert torch.equal(x0 + lay.lane % chip_smoke.LANES_W, i % tw)
    assert torch.equal(y0 + (lay.lane // chip_smoke.LANES_W) * chip_smoke.PAIRS_R + lay.slot,
                       i // tw)
    assert bool(((i % tw <= x1) & (i // tw <= y1)).all())
    key = (lay.patch * 32 + lay.lane) * chip_smoke.PAIRS_R + lay.slot
    assert len(torch.unique(key)) == th * tw
    npx = -(-tw // chip_smoke.LANES_W)
    assert lay.bounds.shape[0] == npx * -(-th // (chip_smoke.LANES_H * chip_smoke.PAIRS_R))


T, K, TILE, NX, CHUNK = 4, 289, (32, 128), 2, 256


@pytest.fixture(scope="module")
def scene():
    win, counts, origins = chip_smoke.random_windows(T, K, TILE, NX, seed=1, device="cpu")
    counts[1] = K  # tiles of 0, K (two slots, the second part-filled) and random rows
    rows, tid, flags = chip_smoke.ragged_from_windows(win, counts, CHUNK)
    bg = torch.tensor([1.0, 0.5, 0.25])
    rg = (rows, tid, flags, bg, 0.0)
    full = kn.composite_pairs_fwd_rg_plain(*rg, TILE, T, CHUNK, NX)
    g_full = torch.randn(full.shape, generator=torch.Generator().manual_seed(2))
    drows = kn.composite_pairs_bwd_rg_plain(*rg, full, g_full, TILE, T, CHUNK, NX)
    dwin, width, dorig, idx = kn._ragged_as_dense(rows, tid, flags, 0.0, TILE, T, CHUNK, NX)
    _, visits = kn.composite_plain_with_visits(dwin, width, dorig, bg, TILE)
    return dict(rows=rows, tid=tid, flags=flags, bg=bg, full=full, g_full=g_full, drows=drows,
                win=dwin, width=width, origins=dorig, idx=idx, visits=visits)


def _schedule(s, g_full=None):
    """The kernels' schedule on the gathered windows: per row, the warp
    patches its box misses skip it, and q < Q_GATE skips before the exp; the
    blend and replay are ``_scan_forward``'s and ``_replay_backward``'s. With
    ``g_full`` the replay's per-pixel values are summed as the kernel sums
    them: a thread's two pixels in turn, then the warp's lanes by
    __shfl_down_sync's tree, then the patches. Returns (out or dwin, number of
    visits culled, number spared an exp by the gate)."""
    win, n, origins, bg = s["win"], s["width"].long(), s["origins"], s["bg"]
    Tn, _, Kw = win.shape
    R = chip_smoke.PAIRS_R
    lay = chip_smoke.pair_layout(TILE)
    P = TILE[0] * TILE[1]
    px, py = kn._tile_pixels(Tn, TILE, win.device, origins)
    miss_all = chip_smoke.patch_misses(kn.row_pixel_box(win.permute(1, 0, 2)), lay.bounds, origins)
    acc = torch.zeros(4, Tn, P)
    Tr = torch.ones(Tn, P)
    done = torch.zeros(Tn, P, dtype=torch.bool)
    culled = gated = 0
    if g_full is not None:
        full = s["full"]
        tfinal = 1.0 - full[:, 4]
        g_acc = [g_full[:, c] for c in range(4)]
        g_tf = bg[0] * g_full[:, 0] + bg[1] * g_full[:, 1] + bg[2] * g_full[:, 2] - g_full[:, 4]
        A_p = (g_acc[0] * (full[:, 0] - bg[0] * tfinal) + g_acc[1] * (full[:, 1] - bg[1] * tfinal)
               + g_acc[2] * (full[:, 2] - bg[2] * tfinal) + g_acc[3] * full[:, 3] + g_tf * tfinal)
        Pr = torch.zeros(Tn, P)
        dwin = torch.zeros(Tn, 12, Kw)
        npatch = lay.bounds.shape[0]
        flat = (lay.patch * 32 + lay.lane) * R + lay.slot  # the pixel's place in the schedule
    for k in range(int(n.max())):
        live = (k < n)[:, None]
        active = live & ~done
        miss = miss_all[:, :, k][:, lay.patch]
        row = win[:, :, k]
        q, log_op, (A, B, C, dx, dy) = kn._conic_q(row, px, py)
        gate = q < kn.Q_GATE
        culled += int((active & miss).sum())
        gated += int((active & ~miss & gate).sum())
        alpha_un = torch.where(miss | gate, 0.0, torch.exp(q))
        valid = ~miss & ~gate & (q <= log_op) & (alpha_un >= kn.ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=kn.ALPHA_MAX), 0.0)
        done = done | (Tr * (1.0 - alpha) < kn.TERM_EPS)
        hit = valid & ~done
        alpha = torch.where(done, 0.0, alpha)
        w = alpha * Tr
        col = row[:, 8:12]
        if g_full is None:
            acc = acc + w[None] * col.T[:, :, None]
        else:
            cg = (g_acc[0] * col[:, 0:1] + g_acc[1] * col[:, 1:2] + g_acc[2] * col[:, 2:3]
                  + g_acc[3] * col[:, 3:4])
            Pr = Pr + w * cg
            dalpha = Tr * cg - (A_p - Pr) / (1.0 - alpha)
            dq = torch.where(hit, dalpha * alpha_un, 0.0)
            vals = torch.stack([-0.5 * (dx * dx) * dq, -(dx * dy) * dq, -0.5 * (dy * dy) * dq,
                                (A * dx + B * dy) * dq, (B * dx + C * dy) * dq, dq]
                               + [w * g for g in g_acc], dim=2)  # (T, P, 10)
            v = torch.zeros(Tn, npatch * 32 * R, 10).index_copy_(1, flat, vals)
            v = v.reshape(Tn, npatch, 32, R, 10)
            t = v[:, :, :, 0]
            for r in range(1, R):
                t = t + v[:, :, :, r]
            for off in (16, 8, 4, 2, 1):
                t = torch.cat([t[:, :, :off] + t[:, :, off:2 * off], t[:, :, off:]], dim=2)
            red = t[:, :, 0].sum(1)  # (T, 10)
            dwin[:, 0:6, k] = red[:, 0:6]
            dwin[:, 8:12, k] = red[:, 6:10]
        Tr = Tr * (1.0 - alpha)
    if g_full is not None:
        return dwin, culled, gated
    out = torch.stack([acc[0] + Tr * bg[0], acc[1] + Tr * bg[1], acc[2] + Tr * bg[2], acc[3],
                       1.0 - Tr], dim=1)
    return out, culled, gated


def test_schedule_forward_is_the_plain_version(scene):
    out, culled, gated = _schedule(scene)
    assert torch.equal(out, scene["full"])
    # the cull and the gate take work away, and the stats count the same cull
    visits = int(scene["visits"].sum())
    assert culled > 0.2 * visits and gated > 0
    st = chip_smoke.pair_cull_stats(scene["win"], scene["width"], scene["origins"], TILE,
                                    scene["visits"])
    assert st.visits == visits and st.visits_left == visits - culled
    assert 0 < st.warp_rows_culled < st.warp_rows


def test_schedule_backward_is_the_plain_version(scene):
    s = scene
    dwin, culled, _ = _schedule(s, s["g_full"])
    assert culled > 0
    inside = torch.arange(s["idx"].shape[1])[None, :] < s["width"][:, None]
    drows = torch.zeros_like(s["rows"])
    drows[:, s["idx"][inside]] = dwin.permute(1, 0, 2)[:, inside]
    err, ref = kn.bwd_row_errors(drows, s["drows"], 0)
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
    assert bool((ref[used] > 0).all())
    assert float((err[used] / ref[used]).max()) <= 1e-6
    assert not drows[6:8].any() and not drows[:, s["rows"][5] <= -1e9].any()
