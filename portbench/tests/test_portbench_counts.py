"""``counts/``: the visits, contributing visits and pairs the reference's
compositor counts equal a brute-force count, pixel by pixel and row by row,
on a scene of a few dozen Gaussians; and the least time follows the
formula of the program's kernel table."""
import math

import torch

from counts import composite as cc
from reference.core.camera import Camera
from reference.ops.rasterizer import api as ref
from reference.ops.rasterizer.preprocess import project_gaussians

H, W, TILE = 64, 256, (32, 128)


def scene(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    means = torch.stack([u(n) * 2.4 - 1.2, u(n) * 0.8 - 0.4, 2.0 + 2.0 * u(n)], dim=1)
    scales = 0.02 + 0.2 * u(n, 3)
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=1)
    opac = 0.2 + 0.79 * u(n, 1)
    rgb = u(n, 3)
    cam = Camera(torch.eye(3), torch.zeros(3), torch.tensor([60.0, 60.0]),
                 torch.tensor([W / 2.0, H / 2.0]))
    return means, scales, quats, opac, rgb, torch.ones(n, dtype=torch.bool), cam


def brute_force(s, g_full):
    """Visits, contributing visits and pairs, one tile and one row at a time,
    each pixel's transmittance carried row by row."""
    ny, nx = ref.tile_grid((H, W), *TILE)
    th, tw = TILE
    rows = torch.cat([s.params, s.color], dim=1)
    order = torch.argsort(torch.where(s.in_frustum, s.depth, torch.inf), stable=True).tolist()
    visits = hits = pairs = 0
    for t in range(ny * nx):
        ox, oy = (t % nx) * tw, (t // nx) * th
        mine = []
        for i in order:
            if not (s.in_frustum[i] and s.radius[i] > 0):
                continue
            (mx, my), (ex, ey) = s.mean2d[i].tolist(), s.extent[i].tolist()
            x0 = min(max(math.floor((mx - ex) / tw), 0), nx)
            x1 = min(max(math.floor((mx + ex + tw - 1) / tw), 0), nx)
            y0 = min(max(math.floor((my - ey) / th), 0), ny)
            y1 = min(max(math.floor((my + ey + th - 1) / th), 0), ny)
            if x0 <= t % nx < x1 and y0 <= t // nx < y1:
                mine.append(i)
        pairs += len(mine)
        p = torch.arange(th * tw)
        px, py = (p % tw + ox).float(), (p // tw + oy).float()
        tr = torch.ones(th * tw)
        done = torch.zeros(th * tw, dtype=torch.bool)
        for i in mine:
            r = rows[i]
            visits += int((~done).sum())
            dx, dy = px - r[3], py - r[4]
            q = r[5] - 0.5 * (r[0] * (dx * dx) + r[2] * (dy * dy)) - r[1] * (dx * dy)
            a_un = torch.exp(q)
            valid = (q <= r[5]) & (a_un >= ref.ALPHA_MIN)
            alpha = torch.where(valid, torch.clamp(a_un, max=ref.ALPHA_MAX), 0.0)
            done = done | (tr * (1.0 - alpha) < ref.TERM_EPS)
            hits += int((valid & ~done).sum())
            tr = tr * (1.0 - torch.where(done, 0.0, alpha))
    return visits, hits, pairs


def test_counts_equal_brute_force():
    for seed in (0, 1, 2):
        args = scene(40, seed)
        params = [a.clone().requires_grad_(True) for a in args[:5]]
        ref.COUNTS.reset()
        ref.COUNTS.on = True
        try:
            out = ref.rasterize(*params, args[5], args[6], (H, W), torch.full((3,), 0.5))
            (out["img"].sum() + 0.1 * out["depth"].sum() + out["mask"].sum()).backward()
        finally:
            ref.COUNTS.on = False
        s = project_gaussians(*[a.detach() for a in args[:5]], args[5], args[6], (H, W))
        visits, hits, pairs = brute_force(s, None)
        (f_pairs, f_pixels, f_visits), = ref.COUNTS.fwd
        (b_pairs, b_pixels, b_visits, b_hits), = ref.COUNTS.bwd
        assert f_pixels == b_pixels == 4 * TILE[0] * TILE[1]
        assert (f_pairs, f_visits) == (pairs, visits) == (b_pairs, b_visits)
        assert b_hits == hits
        assert 0 < hits < visits


def test_least_time_formula():
    pairs, pixels, visits, hits = 1000, 4096, 10**9, 3 * 10**8
    assert cc.forward_least_s(pairs, pixels, visits) == max(
        visits * 13 / 67e12, (pairs * 40 + pixels * 20) / 3.35e12)
    assert cc.backward_least_s(pairs, pixels, visits, hits) == max(
        (visits * 13 + hits * 45) / 67e12, (pairs * 80 + pixels * 40) / 3.35e12)
    counts = ref.WorkCounts()
    counts.fwd.append((pairs, pixels, visits))
    counts.bwd.append((pairs, pixels, visits, hits))
    w = cc.work_per_unit(counts, 2)
    assert w["least_s"] == (cc.forward_least_s(pairs, pixels, visits)
                            + cc.backward_least_s(pairs, pixels, visits, hits)) / 2
    assert w["ops"] == (visits * 13 * 2 + hits * 45) / 2
