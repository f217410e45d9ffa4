"""The pair bodies' schedule on the CPU (csrc/composite.cu
``composite_pairs_range``, csrc/composite_bwd.cu ``composite_pairs_range_bwd``,
the one body of the dense, the pair-major and the row-major kernels): the
per-warp row cull by ``kernels.row_pixel_box`` (conic rows) and
``kernels.packed_row_pixel_box`` (packed rows) and the exp gate
``kernels.Q_GATE`` must change nothing, so the schedule's forward is the
plain version's bit for bit and its backward the plain version's up to the
order of its sums, on ragged and dense windows, on packed rows and on
row-major global conic rows with origins. The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""
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
        "kBoxSlackAbs": kn.BOX_SLACK_ABS, "kBoxPackSlack": kn.BOX_PACK_SLACK}
    assert float(torch.tensor(kn.BOX_LN255, dtype=torch.float32)) > LN255
    # the layout the schedule's mirror and chip_smoke.pair_cull_stats assume
    text = open(osp.join(REPO, "exavatar_release_tpu_torch", "csrc", "composite_common.cuh")).read()
    assert "constexpr int kPairsR = %d;" % chip_smoke.PAIRS_R in text
    assert "constexpr int kLanesW = %d, kLanesH = %d;" % (chip_smoke.LANES_W,
                                                          chip_smoke.LANES_H) in text
    assert "constexpr int kWarps = kBlock / 32;" in text and "constexpr int kBlock = 256;" in text
    assert chip_smoke.PAIR_WARPS == 256 // 32
    assert "constexpr float kBoxRel = 1.0f + 1.0f / 1024.0f;" in text
    assert "constexpr float kBoxPad = 1.0f;" in text
    assert kn.BOX_REL == 1.0 + 1.0 / 1024.0 and kn.BOX_PAD == 1.0


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
                win=dwin, width=width, origins=dorig, idx=idx, visits=visits, tile=TILE)


def _warp_sums(t, variant):
    """(T, npatch, 10) sums over each warp's 32 lanes of their values t (T,
    npatch, 32, 10), in the order the kernel takes: __shfl_down_sync's tree,
    or under fusedgrad reduce_butterfly's butterfly (lane l ends with slot l
    >> 1), or under noT / noT+logsp reduce_transpose's sum in lane order."""
    if variant == "fusedgrad":
        lanes = torch.arange(32)
        u = torch.cat([t, torch.zeros(t.shape[:-1] + (6,))], dim=-1)
        for half in (8, 4, 2, 1):
            up = ((lanes & (2 * half)) != 0)[:, None]
            other = u[:, :, lanes ^ (2 * half)]
            u = (torch.where(up, u[..., half:2 * half], u[..., :half])
                 + torch.where(up, other[..., half:2 * half], other[..., :half]))
        u = u[..., 0] + u[:, :, lanes ^ 1, 0]
        return u[:, :, 0:20:2]
    if variant in ("noT", "noT+logsp"):
        s = torch.zeros(t.shape[:2] + t.shape[3:])
        for x in range(32):
            s = s + t[:, :, x]
        return s
    for off in (16, 8, 4, 2, 1):
        t = torch.cat([t[:, :, :off] + t[:, :, off:2 * off], t[:, :, off:]], dim=2)
    return t[:, :, 0]


def _scan(n, tile, q_of, color_of, miss_all, back=None, variant="base"):
    """The kernels' schedule over each tile's rows k < n: per row, the warp
    patches whose cull ``miss_all`` (T, npatch, K) marks skip it, and q <
    Q_GATE skips before the exp; the blend and replay are ``_scan_forward``'s
    and ``_replay_backward``'s. ``q_of(k)`` gives (q, log_op, extra) at the
    tile's pixels, ``color_of(k)`` the (T, 4) colors. With ``back`` = (g_acc,
    A_p, grad_of), ``grad_of(dq, extra)`` the six (T, P) coefficient values
    of each pixel, the replay's ten values are summed as the kernel sums
    them: a thread's two pixels in turn, then the warp's lanes
    (``_warp_sums``), then the patches. ``variant``, a stage probe's
    (csrc/composite_probes.cuh), changes the schedule as its hooks do:
    noskip drops the cull and the gate; logsp carries log T; the chunk forms
    (noexp, nomm, chunk) hold T0 and done over each 256-row chunk, and at its
    end take done from the dead of the chunk's last row, or, where the pixel
    skipped that row, from E(cum) T0. Returns (acc (4, T, P), Tr; logsp:
    exp(log T)) or red (T, K, 10), then the number of visits culled and the
    number spared an exp by the gate."""
    Tn = n.shape[0]
    R = chip_smoke.PAIRS_R
    lay = chip_smoke.pair_layout(tile)
    P = tile[0] * tile[1]
    logsp = variant in ("logsp", "noT+logsp")
    chunked = variant in ("noexp", "nomm", "chunk")
    E, L = kn._probe_fns(variant)
    acc = torch.zeros(4, Tn, P)
    Tr = torch.full((Tn, P), 0.0 if logsp else 1.0)
    done = torch.zeros(Tn, P, dtype=torch.bool)
    # the chunk forms: the chunk's sums of wlog (all, and of the rows not
    # dead), its prefix carry, the dead of the last row each pixel evaluated
    # and whether that row ends the chunk
    cum, kept, carry = torch.zeros(Tn, P), torch.zeros(Tn, P), torch.zeros(Tn, P)
    dead, last = torch.zeros_like(done), torch.zeros_like(done)
    culled = gated = 0
    if back is not None:
        g_acc, A_p, grad_of = back
        Pr = torch.zeros(Tn, P)
        red = torch.zeros(Tn, miss_all.shape[2], 10)
        npatch = lay.bounds.shape[0]
        flat = (lay.patch * 32 + lay.lane) * R + lay.slot  # the pixel's place in the schedule
    for k in range(int(n.max())):
        live = (k < n)[:, None]
        active = live & ~done
        q, log_op, extra = q_of(k)
        if variant == "noskip":
            miss = gate = torch.zeros_like(done)
        else:
            miss = miss_all[:, :, k][:, lay.patch]
            gate = q < kn.Q_GATE
        culled += int((active & miss).sum())
        gated += int((active & ~miss & gate).sum())
        alpha_un = torch.where(miss | gate, 0.0, E(q))
        valid = ~miss & ~gate & (q <= log_op) & (alpha_un >= kn.ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=kn.ALPHA_MAX), 0.0)
        col = color_of(k)
        if chunked:
            ends_chunk = kn._chunk_end(k, n).expand_as(done)
            ev = valid & ~done
            wlog = L(-alpha)
            T_c = E(wlog if variant == "nomm" else cum) * Tr
            dead_k = T_c * (1.0 - alpha) < kn.TERM_EPS
            dead = torch.where(ev, dead_k, dead)
            last = torch.where(ev, ends_chunk, last)
            cum = torch.where(ev, cum + wlog, cum)
            hit = ev & ~dead_k
            w = torch.where(hit, alpha * T_c, 0.0)
            kept = torch.where(hit, kept + wlog, kept)
        elif logsp:
            wl = torch.log1p(-alpha)
            done = done | (valid & (Tr + wl < kn.LN_TERM_EPS))
            hit = valid & ~done
            T_c = torch.exp(Tr)
            w = torch.where(hit, torch.exp(torch.clamp(q, max=kn.LN_ALPHA_MAX) + Tr)
                            if back is None else alpha * T_c, 0.0)
        else:
            done = done | (Tr * (1.0 - alpha) < kn.TERM_EPS)
            hit = valid & ~done
            alpha = torch.where(done, 0.0, alpha)
            T_c = Tr
            w = alpha * Tr
        if back is None:
            acc = acc + w[None] * col.T[:, :, None]
        else:
            cg = (g_acc[0] * col[:, 0:1] + g_acc[1] * col[:, 1:2] + g_acc[2] * col[:, 2:3]
                  + g_acc[3] * col[:, 3:4])
            if variant == "nomm":
                P_incl = Pr + w * cg
                carry = torch.where(hit & ends_chunk, w * cg, carry)
            elif chunked:
                carry = torch.where(hit, carry + w * cg, carry)
                P_incl = Pr + carry
            else:
                Pr = Pr + w * cg
                P_incl = Pr
            dalpha = T_c * cg - (A_p - P_incl) / (1.0 - alpha)
            dq = torch.where(hit, dalpha * alpha_un, 0.0)
            vals = torch.stack(grad_of(dq, extra) + [w * g for g in g_acc], dim=2)  # (T, P, 10)
            v = torch.zeros(Tn, npatch * 32 * R, 10).index_copy_(1, flat, vals)
            v = v.reshape(Tn, npatch, 32, R, 10)
            t = v[:, :, :, 0]
            for r in range(1, R):
                t = t + v[:, :, :, r]
            red[:, k] = _warp_sums(t, variant).sum(1)
        if chunked:
            end = live & kn._chunk_end(k, n)
            upd = end & ~done
            # a last row the pixel skipped has alpha = 0
            skipped = (Tr if variant == "nomm" else E(cum) * Tr) < kn.TERM_EPS
            Tr = torch.where(upd, Tr * E(kept), Tr)
            if back is not None:
                Pr = torch.where(upd, Pr + carry, Pr)
            done = torch.where(upd, torch.where(last, dead, skipped), done)
            cum, kept, carry = (torch.where(end, 0.0, x) for x in (cum, kept, carry))
            dead, last = dead & ~end, last & ~end
        elif logsp:
            Tr = torch.where(hit, Tr + wl, Tr)
        else:
            Tr = Tr * (1.0 - alpha)
    if back is not None:
        return red, culled, gated
    return (acc, torch.exp(Tr) if logsp else Tr), culled, gated


def _conic_grad(dq, extra):
    """The six values of a conic row's gradient at each pixel, direct terms
    from the pixel's offset to the center, as the kernels add them."""
    A, B, C, dx, dy = extra
    return [-0.5 * (dx * dx) * dq, -(dx * dy) * dq, -0.5 * (dy * dy) * dq,
            (A * dx + B * dy) * dq, (B * dx + C * dy) * dq, dq]


def _schedule(s, g_full=None):
    """``_scan`` on conic windows (a tile's rows k < width, the box in global
    pixel coordinates at the tiles' origins). Returns (out or dwin, number
    of visits culled, number spared an exp by the gate)."""
    win, n, origins, bg, tile = s["win"], s["width"].long(), s["origins"], s["bg"], s["tile"]
    Tn, _, Kw = win.shape
    px, py = kn._tile_pixels(Tn, tile, win.device, origins)
    lay = chip_smoke.pair_layout(tile)
    miss_all = chip_smoke.patch_misses(kn.row_pixel_box(win.permute(1, 0, 2)), lay.bounds, origins)
    q_of = lambda k: kn._conic_q(win[:, :, k], px, py)
    color_of = lambda k: win[:, 8:12, k]
    if g_full is None:
        (acc, Tr), culled, gated = _scan(n, tile, q_of, color_of, miss_all)
        out = torch.stack([acc[0] + Tr * bg[0], acc[1] + Tr * bg[1], acc[2] + Tr * bg[2], acc[3],
                           1.0 - Tr], dim=1)
        return out, culled, gated
    full = s["full"]
    tfinal = 1.0 - full[:, 4]
    g_acc = [g_full[:, c] for c in range(4)]
    g_tf = bg[0] * g_full[:, 0] + bg[1] * g_full[:, 1] + bg[2] * g_full[:, 2] - g_full[:, 4]
    A_p = (g_acc[0] * (full[:, 0] - bg[0] * tfinal) + g_acc[1] * (full[:, 1] - bg[1] * tfinal)
           + g_acc[2] * (full[:, 2] - bg[2] * tfinal) + g_acc[3] * full[:, 3] + g_tf * tfinal)

    red, culled, gated = _scan(n, tile, q_of, color_of, miss_all, (g_acc, A_p, _conic_grad))
    dwin = torch.zeros(Tn, 12, Kw)
    dwin[:, 0:6] = red[..., 0:6].permute(0, 2, 1)
    dwin[:, 8:12] = red[..., 6:10].permute(0, 2, 1)
    return dwin, culled, gated


def _schedule_rm(quad, color, counts, tile, origins=None, cot=None, variant="base"):
    """``_scan`` on a tile's row-major rows (T, K, 8), read up to min(count,
    K): packed rows with the box and the patches in tile-local coordinates,
    as kernels 3 and 4 run them, or with ``origins`` (T, 2) global conic
    rows with the box in global coordinates and the patches at the tiles'
    origins, as kernels 5 and 6 run them, and under ``variant`` as their
    stage probes do (nodeloc: the gradient's six values in the packed basis
    at the tile-local pixel). cot = (g_accum, g_tfinal, accum, tfinal) for
    the backward. Returns ((accum, tfinal) or (dquad, dcolor), visits
    culled, visits spared an exp by the gate)."""
    Tn, Kq, _ = quad.shape
    n = torch.clamp(counts.long(), max=Kq)
    lx, ly = kn._tile_pixels(Tn, tile, quad.device, origins)
    lay = chip_smoke.pair_layout(tile)
    if origins is None:
        box = kn.packed_row_pixel_box(quad, tile)  # (4, T, K)
        miss_all = chip_smoke.patch_misses(box, lay.bounds, torch.zeros(Tn, 2))
        q_of = lambda k: kn._packed_q(quad[:, k], lx, ly)
    else:
        box = kn.row_pixel_box(quad.permute(2, 0, 1))
        miss_all = chip_smoke.patch_misses(box, lay.bounds, origins)
        q_of = lambda k: kn._conic_q(quad[:, k], lx, ly)
    color_of = lambda k: color[:, k]
    if cot is None:
        (acc, Tr), culled, gated = _scan(n, tile, q_of, color_of, miss_all, variant=variant)
        return (acc.permute(1, 2, 0).contiguous(), Tr[:, :, None]), culled, gated
    g_accum, g_tfinal, accum, tfinal = cot
    g_acc = [g_accum[:, :, c] for c in range(4)]
    A_p = (g_acc[0] * accum[:, :, 0] + g_acc[1] * accum[:, :, 1] + g_acc[2] * accum[:, :, 2]
           + g_acc[3] * accum[:, :, 3] + g_tfinal[:, :, 0] * tfinal[:, :, 0])
    if origins is None or variant == "nodeloc":
        bx, by = kn._tile_pixels(Tn, tile, quad.device)
        basis = (bx, by, bx * bx, bx * by, by * by)
        grad_of = lambda dq, _: [dq] + [dq * b for b in basis]
    else:
        grad_of = _conic_grad
    red, culled, gated = _scan(n, tile, q_of, color_of, miss_all, (g_acc, A_p, grad_of), variant)
    dquad = torch.zeros(Tn, Kq, 8)
    dquad[..., 0:6] = red[..., 0:6]
    return (dquad, red[..., 6:10].contiguous()), culled, gated


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


def test_schedule_on_dense_windows():
    """The dense kernels run the same body on windows the ragged path never
    hands it: a tile whose count exceeds K (the kernel reads min(count, K)
    rows), an empty tile, origins off the tile grid (half a pixel and a band
    offset) and a 20 x 36 tile, not a multiple of the 8 x 8 patch."""
    tile, Kd = (20, 36), 97
    win, counts, origins = chip_smoke.random_windows(4, Kd, tile, 2, seed=3, device="cpu")
    counts[:2] = torch.tensor([Kd + 40, 0], dtype=torch.int32)
    origins = origins + torch.tensor([0.5, 1045.25])
    win[:, 3] += 0.5
    win[:, 4] += 1045.25
    bg = torch.tensor([1.0, 0.5, 0.25])
    dense = (win, counts, origins, bg, tile)
    full = kn.composite_tiles_fwd_cm_plain(*dense)
    g_full = torch.randn(full.shape, generator=torch.Generator().manual_seed(4))
    s = dict(win=win, width=torch.clamp(counts, max=Kd), origins=origins, bg=bg, tile=tile,
             full=full)
    out, culled, gated = _schedule(s)
    assert torch.equal(out, full) and culled > 0 and gated > 0
    assert torch.equal(full[1, :3], bg[:, None].expand(3, tile[0] * tile[1]))
    assert not full[1, 3:].any()
    dwin, _, _ = _schedule(s, g_full)
    want = kn.composite_tiles_bwd_cm_plain(win, counts, origins, bg, full, g_full, tile)
    err, ref = kn.bwd_row_errors(dwin, want, 1)
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
    assert bool((ref[used] > 0).all())
    assert float((err[used] / ref[used]).max()) <= 1e-6
    past = torch.arange(Kd)[None, :] >= counts[:, None]
    assert not want[:, 6:8].any() and not want.permute(0, 2, 1)[past].any()


# --------------------------------------------------------------------------
# (d) packed rows (kernels 3 and 4): the tile-local box and the schedule
# --------------------------------------------------------------------------

PACKED_TILES = [(32, 128), (20, 36)]


def _packed_adversarial(rng, tile, n=800):
    """Packed rows (4n + 240, 8) of a th x tw tile, each packed by the port's
    ``pack_tile_quads`` at a tile origin of a 1920 x 1088 image, and their
    conics' (sx, sy, rho, L = log_op + ln 255) in float64. Four families:
    sigmas 0.3-300 px with correlations up to +-0.999; thin rotated ellipses
    (major axis 1-300 px, minor 0.3-3 px, any angle: near-singular conics,
    k up to ~1e6); small Gaussians (sigmas 0.3-1 px) near the tile's far
    corner, whose |c0| is largest (-0.5 A gx^2 at gx ~ tw); and
    ``_adversarial_rows``' 240 global rows packed at an origin near them.
    The first three put their tile-local means up to one radius outside the
    tile, log-opacities within 1e-4 of -ln 255 for a third of the rows, and
    the ellipse's exact x or y extreme within 1e-3 px of a pixel for half
    of them."""
    from exavatar_release_tpu_torch.ops.rasterizer.preprocess import pack_tile_quads

    th, tw = tile
    sx = np.exp(rng.uniform(np.log(0.3), np.log(300.0), n))
    sy = np.exp(rng.uniform(np.log(0.3), np.log(300.0), n))
    rho = rng.uniform(-0.999, 0.999, n)
    rho[:8] = [0.999, -0.999] * 4
    big = np.exp(rng.uniform(0.0, np.log(300.0), n))
    small = np.exp(rng.uniform(np.log(0.3), np.log(3.0), n))
    ang = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(ang), np.sin(ang)
    vxx, vyy = (big * c) ** 2 + (small * s) ** 2, (big * s) ** 2 + (small * c) ** 2
    vxy = (big ** 2 - small ** 2) * s * c
    sx = np.concatenate([sx, np.sqrt(vxx), rng.uniform(0.3, 1.0, 2 * n)])
    sy = np.concatenate([sy, np.sqrt(vyy), rng.uniform(0.3, 1.0, 2 * n)])
    rho = np.concatenate([rho, vxy / np.sqrt(vxx * vyy), rng.uniform(-0.9, 0.9, 2 * n)])
    m = len(sx)
    log_op = np.log(rng.uniform(1.0 / 255.0, 1.0, m))
    near = rng.random(m) < 1.0 / 3.0
    log_op[near] = -LN255 + rng.uniform(-1e-4, 1e-4, near.sum())
    L = np.maximum(log_op + LN255, 0.0)
    ex, ey = np.sqrt(2 * L) * sx, np.sqrt(2 * L) * sy
    gx, gy = rng.uniform(-ex, tw - 1 + ex), rng.uniform(-ey, th - 1 + ey)
    corner = np.arange(m) >= 2 * n  # the third family
    gx[corner] = tw - 1 + rng.uniform(-1.0, 1.0, corner.sum()) * ex[corner]
    gy[corner] = th - 1 + rng.uniform(-1.0, 1.0, corner.sum()) * ey[corner]
    tangent = rng.random(m) < 0.5
    side = rng.integers(0, 4, m)
    d = rng.uniform(-1e-3, 1e-3, m)
    for i in np.flatnonzero(tangent):
        if side[i] < 2:
            edge = gx[i] + (ex[i] if side[i] == 0 else -ex[i])
            gx[i] += np.round(edge) - edge + d[i]
        else:
            edge = gy[i] + (ey[i] if side[i] == 2 else -ey[i])
            gy[i] += np.round(edge) - edge + d[i]
    ox = rng.integers(0, 1920 // tw, m) * tw
    oy = rng.integers(0, 1088 // th, m) * th
    cov_det = (sx * sy) ** 2 * (1 - rho ** 2)
    z = np.zeros(m)
    rows = np.stack([sy ** 2 / cov_det, -rho * sx * sy / cov_det, sx ** 2 / cov_det, gx + ox,
                     gy + oy, log_op, z, z], 1)
    origins = np.stack([ox, oy], 1)
    # the 240 adversarial global rows, at an origin that puts each center
    # within a radius of the tile
    adv = _adversarial_rows(rng).T.astype(np.float64)
    a_sx, a_sy = (np.sqrt(adv[:, 2 - 2 * i] / (adv[:, 0] * adv[:, 2] - adv[:, 1] ** 2))
                  for i in (0, 1))
    a_L = np.maximum(adv[:, 5] + LN255, 0.0)
    a_ex, a_ey = np.sqrt(2 * a_L) * a_sx, np.sqrt(2 * a_L) * a_sy
    a_o = np.round(adv[:, 3:5] - np.stack([rng.uniform(-a_ex, tw - 1 + a_ex),
                                          rng.uniform(-a_ey, th - 1 + a_ey)], 1))
    rows = np.concatenate([rows, adv[:, :8]])
    origins = np.concatenate([origins, a_o])
    quad = pack_tile_quads(torch.from_numpy(rows.astype(np.float32)),
                           torch.from_numpy(origins.astype(np.float32)))
    shape = (np.concatenate([sx, a_sx]), np.concatenate([sy, a_sy]),
             np.concatenate([rho, -adv[:, 1] / np.sqrt(adv[:, 0] * adv[:, 2])]),
             np.concatenate([log_op, adv[:, 5]]) + LN255)
    return quad, shape


def _composited_packed(quad, tile):
    """The plain version's test of packed rows (n, 8) at every pixel of a
    tile: q <= log_op and exp(q) >= 1/255, from ``_packed_q``'s float32 q
    -> (n, P), and the pixels' tile-local (lx, ly) (1, P)."""
    lx, ly = kn._tile_pixels(1, tile, "cpu")
    q, log_op, _ = kn._packed_q(quad, lx, ly)
    return (q <= log_op) & (torch.exp(q) >= kn.ALPHA_MIN), lx, ly


@pytest.mark.parametrize("tile", PACKED_TILES)
def test_packed_box_is_conservative(tile):
    """Every pixel of the tile that composites a packed row lies in its
    ``packed_row_pixel_box``: the pixels just outside a box (within 2 px,
    hundreds of thousands of them) all skip the row. Also the -1e9 padding
    rows (empty) and rows whose Q is not positive definite (the whole
    plane; a negative-definite one would composite pixels far from its
    q*)."""
    quad, _ = _packed_adversarial(np.random.default_rng(7), tile)
    pad = quad[:2].clone()
    pad[:, 0] += -1e9
    pad[:, 6] = -1e9
    bad = quad[:4].clone()
    bad[:, 3:6] = torch.tensor([[-0.5, -1.5, -0.5], [-0.5, -1.0, -0.5], [0.5, 0.0, 0.5],
                                [0.5, 0.0, -0.5]])
    bad[:, 0] = torch.tensor([-1.0, -1.0, -100.0, -1.0])
    every = torch.cat([quad, pad, bad])
    box = kn.packed_row_pixel_box(every, tile)
    n = quad.shape[0]
    assert torch.isinf(box[:, n + 2:]).all() and (box[0, n + 2:] < 0).all()
    assert (box[0, n:n + 2] > box[1, n:n + 2]).all()
    hit, lx, ly = _composited_packed(every, tile)
    assert hit[n + 2 + 2].any()  # the negative-definite row does composite
    b = box[:, :, None]
    inside = (lx >= b[0]) & (lx <= b[1]) & (ly >= b[2]) & (ly <= b[3])
    missed = hit & ~inside
    assert not missed.any(), [(i, every[i].tolist(), box[:, i].tolist())
                              for i in torch.nonzero(missed.any(1)).flatten()[:3].tolist()]
    # the sample covers what it claims: boxes that cut the tile, pixels just
    # outside them, empty boxes of near-threshold rows, rows that give up
    near = ~inside & (lx >= b[0] - 2) & (lx <= b[1] + 2) & (ly >= b[2] - 2) & (ly <= b[3] + 2)
    finite = torch.isfinite(box[0]) & (box[0] <= box[1])
    cuts = finite & ((box[0] > 0) | (box[1] < tile[1] - 1) | (box[2] > 0) | (box[3] < tile[0] - 1))
    assert int(near.sum()) > 50_000 and int(cuts.sum()) > 2_000 and int(hit.sum()) > 100_000
    assert int((box[0, :n] > box[1, :n]).sum()) >= 100 and int(torch.isinf(box[0, :n]).sum()) >= 100


@pytest.mark.parametrize("tile", PACKED_TILES)
def test_packed_box_is_tight(tile):
    """Not vacuous: for well-shaped rows (|rho| <= 0.8, sigmas >= 1 px, L =
    log_op + ln 255 >= 1) the box's half-extents, less its one-pixel pad,
    are at most 1.3 times the exact ellipse's (in float64 from the packed
    coefficients themselves) and 1.01 times at the median, and its center
    lies within 0.01 px of the exact one."""
    quad, (sx, sy, rho, L) = _packed_adversarial(np.random.default_rng(8), tile)
    box = kn.packed_row_pixel_box(quad, tile).double()
    c = quad.double()
    A, B, C = -2 * c[:, 3], -c[:, 4], -2 * c[:, 5]
    det = A * C - B * B
    mx, my = (C * c[:, 1] - B * c[:, 2]) / det, (A * c[:, 2] - B * c[:, 1]) / det
    Ls = c[:, 0] + 0.5 * (c[:, 1] * mx + c[:, 2] * my) + LN255
    ok = torch.from_numpy((np.abs(rho) <= 0.8) & (np.minimum(sx, sy) >= 1.0) & (L >= 1.0))
    assert int(ok.sum()) >= 400 and bool(torch.isfinite(box[:, ok]).all())
    ratio = torch.maximum(((box[1] - box[0]) / 2 - kn.BOX_PAD) / torch.sqrt(2 * Ls * C / det),
                          ((box[3] - box[2]) / 2 - kn.BOX_PAD) / torch.sqrt(2 * Ls * A / det))[ok]
    off = torch.maximum(((box[0] + box[1]) / 2 - mx).abs(), ((box[2] + box[3]) / 2 - my).abs())
    assert float(ratio.max()) <= 1.3 and float(ratio.median()) <= 1.01
    assert float(off[ok].max()) <= 0.01


def _packed_windows(tile, T, K, seed, counts):
    """Seeded windows (``chip_smoke.random_windows``) repacked at their
    tiles' origins, the first counts replaced: (packed (T, K, 8), colors (T,
    K, 4), counts)."""
    win, cnt, origins = chip_smoke.random_windows(T, K, tile, 2, seed=seed, device="cpu")
    cnt[:len(counts)] = torch.tensor(counts, dtype=torch.int32)
    _, packed, color = chip_smoke.rm_rows_from_windows(win, origins)
    return packed, color, cnt


@pytest.mark.parametrize("case", ["random_32x128", "dense_20x36"])
def test_packed_schedule_is_the_plain_version(case):
    """Kernels 3 and 4's schedule (``_schedule_rm``: tile-local patches
    and boxes, the gate, two pixels a thread, then the warp's shuffle tree)
    on packed rows: the forward bit-equal to ``composite_tiles_fwd_v2_plain``,
    the backward within 1e-6 of each row's largest value of
    ``composite_tiles_bwd_v2_plain``, its lanes 6-7 and its slots at or past
    min(count, K) zero. Tiles of K rows and of none; a count above K; a 20 x
    36 tile, not a multiple of the 8 x 8 patch. The stats model
    (``chip_smoke.pair_cull_stats`` without origins) counts the same cull."""
    tile, K, counts = (((32, 128), 289, [289, 0]) if case == "random_32x128"
                       else ((20, 36), 97, [97 + 40, 0]))
    packed, color, cnt = _packed_windows(tile, 4, K, 5, counts)
    (acc, tf), culled, gated = _schedule_rm(packed, color, cnt, tile)
    want_acc, want_tf, visits = kn.composite_rm_plain_with_visits(packed, color, cnt, tile)
    assert torch.equal(acc, want_acc) and torch.equal(tf, want_tf)
    total = int(visits.sum())
    assert culled > 0.2 * total and gated > 0
    st = chip_smoke.pair_cull_stats(packed, cnt, None, tile, visits)
    assert st.visits == total and st.visits_left == total - culled
    assert 0 < st.warp_rows_culled < st.warp_rows
    g = torch.Generator().manual_seed(6)
    P = tile[0] * tile[1]
    cot = (torch.randn(4, P, 4, generator=g), torch.randn(4, P, 1, generator=g), want_acc, want_tf)
    (dq, dc), _, _ = _schedule_rm(packed, color, cnt, tile, cot=cot)
    wq, wc = kn.composite_tiles_bwd_v2_plain(packed, color, cnt, *cot, tile)
    err, ref = kn.bwd_row_errors(torch.cat([dq, dc], 2), torch.cat([wq, wc], 2), 2)
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
    assert bool((ref[used] > 0).all())
    assert float((err[used] / ref[used]).max()) <= 1e-6
    past = torch.arange(K)[None, :] >= cnt[:, None]
    assert not dq[..., 6:].any() and not wq[past].any() and not dq[past].any()
    assert not dc[past].any()


def test_packed_schedule_vs_pallas_interpret():
    """At the smallest shape the JAX package's tests compare (4 tiles of 8 x
    32, K = 256, the rows of tests/test_torch_rowmajor.py's fixture: opaque
    Gaussians that clamp alpha and end pixels, garbage past tile 1's count)
    the schedule's forward on rows packed by the JAX package's
    ``pack_tile_quads`` against ``pallas_kernels.composite_tiles_fwd_v2`` in
    interpret mode, at that file's tolerances (the Pallas kernel carries T
    through log-space prefix products)."""
    import jax.numpy as jnp

    from exavatar_release_tpu.ops.rasterizer import pallas_kernels as pk
    from exavatar_release_tpu.ops.rasterizer.preprocess import pack_tile_quads as j_pack
    from torch_windows import windows

    tile = (8, 32)
    win, counts, origins = windows(np.random.default_rng(31), T=4, K=256, tile_shape=tile)
    win[:, 5, ::9] = 0.0
    win[:, 3, ::9] = np.round(win[:, 3, ::9]) + 0.25
    win[:, 4, ::9] = np.round(win[:, 4, ::9]) + 0.25
    rows_g = np.ascontiguousarray(win[:, :8].transpose(0, 2, 1))
    color = np.ascontiguousarray(win[:, 8:].transpose(0, 2, 1))
    packed = np.array(j_pack(jnp.asarray(rows_g), jnp.asarray(origins)[:, None, :]))
    packed[1, int(counts[1]):] = 7.0  # never read
    j_acc, j_tf = pk.composite_tiles_fwd_v2(jnp.asarray(packed), jnp.asarray(color),
                                            jnp.asarray(counts), tile, chunk=128, interpret=True)
    (acc, tf), culled, gated = _schedule_rm(torch.from_numpy(packed), torch.from_numpy(color),
                                            torch.from_numpy(counts), tile)
    assert culled > 0 and gated > 0
    np.testing.assert_allclose(acc[..., :3].numpy(), np.asarray(j_acc)[..., :3], atol=1e-5)
    np.testing.assert_allclose(acc[..., 3].numpy(), np.asarray(j_acc)[..., 3], atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(j_tf), atol=1e-5)
    assert float(tf.min()) < 2e-4  # some pixels terminated


# --------------------------------------------------------------------------
# (e) global conic rows with origins, row-major (kernels 5 and 6)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random_32x128", "dense_20x36"])
def test_conic_rm_schedule_is_the_plain_version(case):
    """Kernels 5 and 6's schedule (``_schedule_rm`` with origins: global
    boxes, patches at the tiles' origins, the gate, two pixels a thread,
    then the warp's shuffle tree) on global conic rows (T, K, 8): the
    forward bit-equal to ``composite_tiles_fwd_plain`` with origins, the
    backward within 1e-6 of each row's largest value of
    ``composite_tiles_bwd_plain`` with origins, its lanes 6-7 and its slots
    at or past min(count, K) zero. Tiles of K rows and of none; a count above
    K; a 20 x 36 tile, not a multiple of the 8 x 8 patch, at origins off the
    tile grid (half a pixel and a band offset). The stats model
    (``chip_smoke.pair_cull_stats`` on the rows transposed) counts the same
    cull."""
    tile, K, counts = (((32, 128), 289, [289, 0]) if case == "random_32x128"
                       else ((20, 36), 97, [97 + 40, 0]))
    win, cnt, origins = chip_smoke.random_windows(4, K, tile, 2, seed=7, device="cpu")
    cnt[:2] = torch.tensor(counts, dtype=torch.int32)
    if case == "dense_20x36":
        shift = torch.tensor([0.5, 1045.25])
        origins = origins + shift
        win[:, 3:5] += shift[:, None]
    rows_g, _, color = chip_smoke.rm_rows_from_windows(win, origins)
    (acc, tf), culled, gated = _schedule_rm(rows_g, color, cnt, tile, origins)
    want_acc, want_tf, visits = kn.composite_rm_plain_with_visits(rows_g, color, cnt, tile,
                                                                  origins)
    assert torch.equal(acc, want_acc) and torch.equal(tf, want_tf)
    assert torch.equal(want_acc[1], torch.zeros_like(want_acc[1]))
    assert torch.equal(want_tf[1], torch.ones_like(want_tf[1]))
    total = int(visits.sum())
    assert culled > 0.2 * total and gated > 0
    st = chip_smoke.pair_cull_stats(rows_g.transpose(1, 2), cnt, origins, tile, visits)
    assert st.visits == total and st.visits_left == total - culled
    assert 0 < st.warp_rows_culled < st.warp_rows
    g = torch.Generator().manual_seed(8)
    P = tile[0] * tile[1]
    cot = (torch.randn(4, P, 4, generator=g), torch.randn(4, P, 1, generator=g), want_acc, want_tf)
    (dq, dc), _, _ = _schedule_rm(rows_g, color, cnt, tile, origins, cot)
    wq, wc = kn.composite_tiles_bwd_plain(rows_g, color, cnt, *cot, tile, origins)
    err, ref = kn.bwd_row_errors(torch.cat([dq, dc], 2), torch.cat([wq, wc], 2), 2)
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
    assert bool((ref[used] > 0).all())
    assert float((err[used] / ref[used]).max()) <= 1e-6
    past = torch.arange(K)[None, :] >= cnt[:, None]
    assert not dq[..., 6:].any() and not wq[past].any() and not dq[past].any()
    assert not dc[past].any()


def test_conic_rm_schedule_vs_pallas_interpret():
    """At the smallest shape the JAX package's tests compare (4 tiles of 8 x
    32, K = 256, the rows of tests/test_torch_rowmajor.py's fixture: opaque
    Gaussians that clamp alpha and end pixels, garbage past tile 1's count)
    kernels 5 and 6's schedule on global conic rows with origins against
    ``pallas_kernels.composite_tiles_fwd`` / ``composite_tiles_bwd`` with
    ``tile_origins`` in interpret mode, at that file's tolerances: forward
    1e-5 (depth 1e-4), each gradient lane 5e-4 of its largest value (the
    Pallas kernels carry T through log-space prefix products and reach the
    conic's gradient through the packed basis)."""
    import jax.numpy as jnp

    from exavatar_release_tpu.ops.rasterizer import pallas_kernels as pk
    from torch_windows import windows

    tile = (8, 32)
    rng = np.random.default_rng(31)
    win, counts, origins = windows(rng, T=4, K=256, tile_shape=tile, nx=2)
    win[:, 5, ::9] = 0.0
    win[:, 3, ::9] = np.round(win[:, 3, ::9]) + 0.25
    win[:, 4, ::9] = np.round(win[:, 4, ::9]) + 0.25
    rows_g = np.ascontiguousarray(win[:, :8].transpose(0, 2, 1))
    color = np.ascontiguousarray(win[:, 8:].transpose(0, 2, 1))
    n1 = int(counts[1])
    rows_g[1, n1:] = 7.0  # never read
    P = tile[0] * tile[1]
    cot = (rng.normal(size=(4, P, 4)).astype(np.float32),
           rng.normal(size=(4, P, 1)).astype(np.float32))
    j = jnp.asarray
    args = (rows_g, color, counts)
    j_acc, j_tf = pk.composite_tiles_fwd(*map(j, args), tile, chunk=128, interpret=True,
                                         tile_origins=j(origins))
    j_dq, j_dc = pk.composite_tiles_bwd(*map(j, args), *map(j, cot), j_acc, j_tf, tile,
                                        chunk=128, interpret=True, tile_origins=j(origins))
    t = torch.from_numpy
    (acc, tf), culled, gated = _schedule_rm(*map(t, args), tile, t(origins))
    assert culled > 0 and gated > 0
    np.testing.assert_allclose(acc[..., :3].numpy(), np.asarray(j_acc)[..., :3], atol=1e-5)
    np.testing.assert_allclose(acc[..., 3].numpy(), np.asarray(j_acc)[..., 3], atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(j_tf), atol=1e-5)
    assert float(tf.min()) < 2e-4  # some pixels terminated
    # each backward replays its own forward's outputs
    (dq, dc), _, _ = _schedule_rm(*map(t, args), tile, t(origins), (*map(t, cot), acc, tf))
    live = np.ones((4, 256), bool)
    live[1, n1:] = False
    for name, g, w, lanes in (("dquad", dq.numpy(), np.asarray(j_dq), 6),
                              ("dcolor", dc.numpy(), np.asarray(j_dc), 4)):
        assert g.shape == w.shape and not g[~live].any(), name
        for lane in range(lanes):
            err = float(np.abs(g[..., lane] - w[..., lane])[live].max())
            assert err <= 5e-4 * float(np.abs(w[..., lane][live]).max()), (name, lane, err)
        assert not g[..., lanes:].any(), name


# --------------------------------------------------------------------------
# (f) the stage probes (kernels 9 and 10): kernels 5 and 6's schedule under
# each variant's hooks
# --------------------------------------------------------------------------

VARIANT_CASES = ([f"fwd/{v}" for v in kn.FWD_VARIANTS]
                 + [f"bwd/{v}" for v in kn.BWD_VARIANTS if v != "nograd"])


@pytest.fixture(scope="module")
def chunk_edge_inputs():
    """Per tile shape, (f)'s windows as global conic rows with their plain
    forward and the patch misses of each first chunk's last row: the same
    inputs for every variant."""
    from torch_windows import chunk_edge_windows

    out = []
    for tile, T, seed in (((32, 128), 2, 41), ((20, 36), 4, 42)):
        win, counts, origins = map(torch.from_numpy, chunk_edge_windows(
            np.random.default_rng(seed), T=T, tile_shape=tile))
        rows_g, _, color = chip_smoke.rm_rows_from_windows(win, origins)
        f = kn.composite_rm_plain_with_visits(rows_g, color, counts, tile, origins)
        box = kn.row_pixel_box(rows_g[:, 255:256].permute(2, 0, 1))
        miss = chip_smoke.patch_misses(box, chip_smoke.pair_layout(tile).bounds, origins)
        out.append((tile, T, seed, rows_g, color, counts, origins, f, miss))
    return out


@pytest.mark.parametrize("case", VARIANT_CASES)
def test_variant_schedule_is_the_plain_version(case, chunk_edge_inputs):
    """The stage probes' schedule (``_schedule_rm`` with origins under a
    variant: the cull and the gate wherever the variant keeps them, its
    hooks' blend or replay, its warp sums) on windows where the cull meets
    the chunk forms' bookkeeping (``torch_windows.chunk_edge_windows``:
    counts past one 256-row batch, each chunk's last row at the tile's
    corner, culled by all patches but one, opaque rows that end pixels
    inside the first chunk), on tiles of 32 x 128 and 20 x 36: the forward
    bit-equal to ``composite_tiles_fwd_variant_plain``, the backward within
    1e-6 of each row's largest value of ``composite_tiles_bwd_variant_plain``
    (the warps sum in another order than the plain version)."""
    d, variant = case.split("/")
    for tile, T, seed, rows_g, color, counts, origins, f, miss in chunk_edge_inputs:
        # the inputs bite: pixels end inside the first chunk, and the box of
        # each first chunk's last row misses most patches
        assert float((f[2] < 256).float().mean()) > 0.1, tile
        assert float(miss.float().mean()) > 0.8, tile
        if d == "fwd":
            (acc, tf), culled, gated = _schedule_rm(rows_g, color, counts, tile, origins,
                                                    variant=variant)
            want = kn.composite_tiles_fwd_variant_plain(variant, rows_g, color, counts, tile,
                                                        origins)
            assert torch.equal(acc, want[0]) and torch.equal(tf, want[1]), tile
            assert (culled > 0 and gated > 0) == (variant != "noskip")
            continue
        g = torch.Generator().manual_seed(seed)
        P = tile[0] * tile[1]
        cot = (torch.randn(T, P, 4, generator=g), torch.randn(T, P, 1, generator=g), *f[:2])
        (dq, dc), culled, gated = _schedule_rm(rows_g, color, counts, tile, origins, cot, variant)
        assert culled > 0 and gated > 0
        wq, wc = kn.composite_tiles_bwd_variant_plain(variant, rows_g, color, counts, *cot, tile,
                                                      origins)
        err, ref = kn.bwd_row_errors(torch.cat([dq, dc], 2), torch.cat([wq, wc], 2), 2)
        used = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]
        assert bool((ref[used] > 0).all()), tile
        assert float((err[used] / ref[used]).max()) <= 1e-6, tile
