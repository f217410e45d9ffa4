#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (``exavatar_release_tpu_torch``; nothing of JAX or of
the JAX package) and fails with a non-zero exit when any phase fails:

1. builds the CUDA kernels from ``exavatar_release_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the card's name and power limit;
2. holds each of the eight compositing kernels, forward and backward,
   against its plain PyTorch version on the card, on seeded random windows at
   the 1080p tiling (random cotangents for the backward; each of its ten used
   rows against that row's own largest value), and the forward kernels
   against each other on the same scene; for the pair-major kernels (7 and
   8) it prints, here, at the animate frame and at the train render, what
   their per-warp row cull leaves (``pair_cull_stats``, a model of it), and after
   the build their registers, shared memory and spills;
3. renders the golden scenes of ``tests/goldens`` through the dense and the
   pair-major path and compares outputs and input gradients with the
   frozen reference and with the same render on CPU tensors;
4. animates a full-width avatar (synthetic SMPL-X at ~10.4k vertices, ~166k
   human Gaussians after 2x subdivision, triplane 32 ch x 128, 1920x1080,
   focal 1200, subject at z = 2.5, tiles 32x128) through
   ``apps.animate.render_motion``, pair-major and dense, with every launch
   counter set to 0 just before and read just after; checks the frames and
   holds both kernels against their plain versions on the frame's own
   inputs; times the frame split into human_forward, projection+binning and
   composite, and each kernel beside its bound and its plain version;
5. runs the differentiable frame at the same width with a scene of 20,000
   live Gaussians (capacity 32,768) behind the human: one test-mode
   ``forward_frame`` and ``train.loop.loss_and_grads`` (five Gaussian
   renders, two face-mesh renders, 22 losses, gradients of every trainable
   and of the scene's screen-space means), pair-major and dense, counters
   at 0 just before and read just after; holds both backward kernels
   against their plain versions, row by row, on the frame's own windows
   under an image, mask and depth cotangent;
   times forward, backward and each backward kernel and prints the peak
   memory and a profile;
6. trains at the same width (``phase_train``): ``apps.train.train_loop`` from
   the default ``RasterizeSettings()`` with a capacity governor of patience
   1 until it has switched to pair-major and loses no pair; further steps on
   one frame (loss falls, statistics tracked, time per step split into
   ``loss_and_grads``, optimizer update and ``track_stats``); densify/prune
   with the Adam-moment surgery, opacity reset, capacity growth; a
   checkpoint written and read back on the card; and the same step through
   ``kernel_v=2``, whose row-major kernels (and the two of the row-major
   boundary with origins) are held against their plain versions on that
   step's windows.

Weights are random, drawn from seeded ``torch.Generator``s and then brought
into a trained avatar's range (Gaussian scales of ~6 mm, offsets of ~mm),
so tile occupancy and pair counts are those of a real avatar. TF32 is off
for matmuls and cuDNN. The last two lines are the ``kernels`` JSON and the
contract line ``{"ok": true, "device": {...}}``; the card's name and power
limit come on the line before them.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores and
# HBM bandwidth, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_VISIT = 13  # ~12 f32 operations + 1 exp per (pixel, Gaussian) visit
BYTES_PER_ROW = 40  # 10 used f32 channels of a live row
BYTES_PER_PIXEL = 20  # 5 f32 outputs

# backward: operations per visit that contributes a gradient, counted from
# the inner loop of csrc/composite_bwd.cu (35) plus the 10 adds that sum its
# ten values over pixels; bytes per pixel of full and g_full
OPS_PER_HIT = 45
BWD_BYTES_PER_PIXEL = 40

# row-major rows: 8 + 4 f32 of a live row; the backward reads g_accum,
# g_tfinal, accum and tfinal per pixel
RM_BYTES_PER_ROW = 48

FWD_KERNELS = ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg")
BWD_KERNELS = ("composite_tiles_bwd_cm", "composite_pairs_bwd_rg")
RM_FWD_KERNELS = ("composite_tiles_fwd_v2", "composite_tiles_fwd")
RM_BWD_KERNELS = ("composite_tiles_bwd_v2", "composite_tiles_bwd")
# the measuring kernels of the probe tools
PROBE_KERNELS = ("composite_tiles_fwd_variant", "composite_tiles_bwd_variant", "tile_windows")
ALL_KERNELS = FWD_KERNELS + BWD_KERNELS + RM_FWD_KERNELS + RM_BWD_KERNELS + PROBE_KERNELS
KERNEL_SOURCE = {k: "exavatar_release_tpu_torch/csrc/composite.cu" for k in FWD_KERNELS}
KERNEL_SOURCE.update({k: "exavatar_release_tpu_torch/csrc/composite_bwd.cu" for k in BWD_KERNELS})
KERNEL_SOURCE.update({k: "exavatar_release_tpu_torch/csrc/composite_rm.cu"
                      for k in RM_FWD_KERNELS + RM_BWD_KERNELS + PROBE_KERNELS[:2]})
KERNEL_SOURCE["tile_windows"] = "exavatar_release_tpu_torch/csrc/windows.cu"
_PK = "exavatar_release_tpu/ops/rasterizer/pallas_kernels.py"
REPLACES = {
    "composite_tiles_fwd_variant": "tools/kvariants.py:393",
    "composite_tiles_bwd_variant": "tools/kvariants.py:429",
    "tile_windows": "tools/win_probe.py:46",
    "composite_tiles_fwd_cm": f"{_PK}:666",
    "composite_tiles_bwd_cm": f"{_PK}:716",
    "composite_pairs_fwd_rg": f"{_PK}:1389",
    "composite_pairs_bwd_rg": f"{_PK}:1445",
    "composite_tiles_fwd_v2": f"{_PK}:932",
    "composite_tiles_bwd_v2": f"{_PK}:988",
    "composite_tiles_fwd": f"{_PK}:1055",
    "composite_tiles_bwd": f"{_PK}:1110",
}
TOL = {"img": 1e-5, "mask": 1e-5, "depth": 1e-4}  # kernel vs plain, both on the card
# backward kernel vs plain, each of the ten used rows against that row's own
# largest |plain| value (the rows differ in unit by orders of magnitude): the
# kernels sum over pixels with atomics, in an order that differs from the
# plain version's
GRAD_TOL = 1e-4
# kernel_v=2 against kernel_v=1, each gradient leaf against its own largest
# value. The packed form cancels terms of size |dq| 128^2 px^2 down to |dq| dx^2
# when its coefficients' gradients are carried back to the conic, in float32 on
# both sides of the (T, K, 8) interface, and its q differs from the direct
# form's in the last bits, which flips a few 1/255 and 1e-4 thresholds. Leaves
# that are small sums of cancelling terms (the hands' poses) amplify both: on
# an H100 the worst leaf came out at 1.7e-3, 3.2e-3 and 1.1e-2 of its own max
# in three runs and states, while each path repeated itself within 1e-4. The
# limit is the one the JAX package holds its kernel paths' gradients to
# (tests/test_goldens.py); a wrong kernel or a dropped cotangent moves the
# leaves by tenths. The screen-space means' gradient is held to 1e-3.
V2_LEAF_TOL = 2.5e-2
GRAD_ROWS = {0: "dA", 1: "dB", 2: "dC", 3: "dgx", 4: "dgy", 5: "dlog_op", 8: "dr", 9: "dg",
             10: "db", 11: "ddepth"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_err(a, b) -> dict:
    """Max abs difference of (T, 5, P) composites, per output."""
    d = (a - b).abs()
    return {"img": float(d[:, 0:3].max()), "depth": float(d[:, 3].max()),
            "mask": float(d[:, 4].max())}


def scaled_err(a, b) -> float:
    """Max abs difference over max(1, max |b|): the goldens' gradient norm."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def own_scale_err(a, b) -> float:
    """Max abs difference over max |b|, with no floor: 0 when both are zero."""
    d, m = float((a - b).abs().max()), float(b.abs().max())
    return d / m if m > 0 else (0.0 if d == 0 else math.inf)


def grad_rows(got, want, row_dim: int) -> dict:
    """A backward kernel's output against the plain version's, row by row:
    ``rows`` maps each used row to (max abs diff, max |plain|, their ratio),
    ``max_row_rel_err`` is the worst ratio, ``max_abs_err`` the largest
    difference anywhere. ``ok``: every used row is live in the reference and
    within GRAD_TOL of it, and the unused rows 6-7 are exactly zero."""
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    err, ref = (x.tolist() for x in kn.bwd_row_errors(got, want, row_dim))
    rows = {n: (err[r], ref[r], err[r] / ref[r] if ref[r] > 0 else math.inf)
            for r, n in GRAD_ROWS.items()}
    worst = max(v[2] for v in rows.values())
    unused_zero = not bool(got.select(row_dim, 6).any() or got.select(row_dim, 7).any())
    return {"rows": rows, "max_row_rel_err": worst, "max_abs_err": max(err),
            "ok": worst <= GRAD_TOL and unused_zero}


def log_grad_rows(tag: str, name: str, r: dict) -> None:
    log(f"[{tag}] {name} vs plain: worst row {r['max_row_rel_err']:.3e} of its own max |plain| "
        f"(limit {GRAD_TOL}), max abs diff {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    log(f"[{tag}]   row: max abs diff / max |plain| = ratio: " + ", ".join(
        f"{n} {e:.2e}/{m:.2e}={q:.1e}" for n, (e, m, q) in r["rows"].items()))


def within(err: dict, tol: dict) -> bool:
    return all(err[k] <= tol[k] for k in tol)


def cuda_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_launches() -> None:
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    for k in ALL_KERNELS:
        getattr(kn, k).launches = 0


def read_launches() -> dict:
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    return {k: getattr(kn, k).launches for k in ALL_KERNELS}


def profile_frame(fn, top: int = 12, what: str = "one pair-major frame") -> dict:
    """Device time of one call of ``fn``: the busy share of its wall time
    (kernel time summed) and the operators that launched the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] {what}: wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%); top operators by device time:")
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} calls  {e.key}")
    return {"wall_ms": wall_ms, "device_ms": device_ms}


def rm_max_err(got, want) -> dict:
    """Max abs difference of (accum (T,P,4), tfinal (T,P,1)) pairs, under the
    names of TOL: img = accum's colors, depth = its fourth lane, mask =
    tfinal (mask = 1 - tfinal)."""
    da, dt = (got[0] - want[0]).abs(), (got[1] - want[1]).abs()
    return {"img": float(da[..., 0:3].max()), "depth": float(da[..., 3].max()),
            "mask": float(dt.max())}


def rm_grad_rows(got, want) -> dict:
    """``grad_rows`` for (dquad (T,K,8), dcolor (T,K,4)) pairs: side by side
    they have the channel-major rows' layout, lanes 6-7 zero."""
    import torch

    return grad_rows(torch.cat(got, dim=2), torch.cat(want, dim=2), 2)


def rm_rows_from_windows(win, origins):
    """Channel-major windows (T, 12, K) as the row-major kernels' inputs:
    (global conic rows (T,K,8), packed coefficients (T,K,8), colors (T,K,4))."""
    from exavatar_release_tpu_torch.ops.rasterizer.preprocess import pack_tile_quads

    rows_g = win[:, :8].transpose(1, 2).contiguous()
    color = win[:, 8:].transpose(1, 2).contiguous()
    return rows_g, pack_tile_quads(rows_g, origins[:, None, :]).contiguous(), color


# --------------------------------------------------------------------------
# phase 2: kernels vs plain on random windows
# --------------------------------------------------------------------------


def random_windows(T: int, K: int, tile_shape, nx: int, seed: int, device):
    """Seeded windows at a tiling: Gaussians of 0.7-8 px around each tile,
    high opacities (so pixels terminate), counts from 0 to K with garbage
    past the count in every other tile."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    th, tw = tile_shape
    t = torch.arange(T)
    origins = torch.stack([(t % nx) * tw, (t // nx) * th], dim=1).float()
    u = lambda *s: torch.rand(*s, generator=g)
    sx, sy = 0.7 + 7.3 * u(T, K), 0.7 + 7.3 * u(T, K)
    rho = 1.6 * u(T, K) - 0.8
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    A, B, C = sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det
    gx = origins[:, 0:1] - 8 + (tw + 16) * u(T, K)
    gy = origins[:, 1:2] - 8 + (th + 16) * u(T, K)
    log_op = torch.log(0.05 + 0.95 * u(T, K))
    z = torch.zeros(T, K)
    win = torch.stack([A, B, C, gx, gy, log_op, z, z, u(T, K), u(T, K), u(T, K),
                       1 + 4 * u(T, K)], dim=1)
    counts = torch.randint(0, K + 1, (T,), generator=g)
    counts[: T // 8] = K
    counts[T // 8: T // 4] = 0
    past = torch.arange(K)[None, :] >= counts[:, None]
    win[:, 5] = torch.where(past & (t[:, None] % 2 == 0), -1e9, win[:, 5])
    return win.to(device), counts.int().to(device), origins.to(device)


def ragged_from_windows(win, counts, chunk: int):
    """The ragged layout of the same rows: each tile's rows at a chunk-aligned
    slot range (>= 1 slot), sentinel padding, and two trailing invalid slots."""
    import torch

    T, _, K = win.shape
    dev = win.device
    nslots = torch.clamp((counts.long() + chunk - 1) // chunk, min=1)
    first = torch.cumsum(nslots, 0) - nslots
    total = int(nslots.sum())
    NC = total + 2
    tid = torch.repeat_interleave(torch.arange(T, device=dev), nslots)
    tid = torch.cat([tid, tid.new_full((2,), T - 1)])
    jc = torch.arange(NC, device=dev)
    valid = jc < total
    is_first = valid & (jc == first[tid])
    is_last = valid & (jc == first[tid] + nslots[tid] - 1)
    flags = is_first.int() + 2 * is_last.int() + 4 * valid.int()
    rows = torch.zeros(12, NC * chunk, device=dev)
    rows[5] = -1e9
    k = torch.arange(K, device=dev)
    live = k[None, :] < counts.long()[:, None]
    dest = (first[:, None] * chunk + k[None, :])[live]
    rows[:, dest] = win.permute(1, 0, 2)[:, live]
    return rows, tid.int(), flags.int()


def ptxas_resources(lib: str, entry: str) -> dict:
    """{the groups of ``entry`` in a kernel's mangled name: (registers, shared
    bytes, spill stores, spill loads)}, from ptxas's report in the build log
    of library ``lib`` (empty off the card)."""
    import re

    from exavatar_release_tpu_torch import cuda_build

    try:
        text = cuda_build.build_log(lib)
    except OSError:
        return {}
    out, cur, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"entry function '\S*" + entry, line)
        if m:
            cur, spill = m.groups(), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), int(m.group(2))) + spill
            cur = None
    return out


def pairs_resources() -> dict:
    """{kernel: (registers, shared bytes, spill stores, spill loads)} of
    kernels 7 and 8."""
    out = {}
    for lib in ("composite", "composite_bwd"):
        for (name,), r in ptxas_resources(lib, r"(composite_pairs_(?:fwd|bwd)_rg)_kernel").items():
            out[name] = r
    return out


# composite_common.cuh's pair-major layout: kPairsR pixels a thread (a
# column), kLanesW x kLanesH lanes a warp, kWarps warps a block
PAIRS_R, LANES_W, LANES_H, PAIR_WARPS = 2, 8, 4, 8


class PairLayout(NamedTuple):
    """Where kernels 7 and 8 put each pixel of a th x tw tile
    (composite_common.cuh ``pair_pixels``). Per tile-local pixel i (P,):
    ``patch``, its warp's patch (block * PAIR_WARPS + warp of the block),
    ``lane`` and ``slot`` (0..PAIRS_R-1 within the thread's column);
    ``bounds`` (npatch, 4) each patch's tile-local [x0, x1, y0, y1], first and
    last pixel, padding past the tile included."""

    patch: object
    lane: object
    slot: object
    bounds: object


def pair_layout(tile_shape, device=None) -> PairLayout:
    import torch

    th, tw = tile_shape
    pw, ph = LANES_W, LANES_H * PAIRS_R
    npx, npy = -(-tw // pw), -(-th // ph)
    i = torch.arange(th * tw, device=device)
    x, y = i % tw, i // tw
    patch = (y // ph) * npx + x // pw
    lane = ((y % ph) // PAIRS_R) * LANES_W + x % pw
    p = torch.arange(npx * npy, device=device)
    x0, y0 = (p % npx) * pw, (p // npx) * ph
    bounds = torch.stack([x0, x0 + pw - 1, y0, y0 + ph - 1], dim=1)
    return PairLayout(patch, lane, y % PAIRS_R, bounds)


def patch_misses(box, bounds, origins):
    """composite_common.cuh ``misses``: boxes (4, T, K) of each tile's rows
    against the patches' tile-local ``bounds`` (npatch, 4) placed at the tiles'
    ``origins`` (T, 2) -> (T, npatch, K), True where the warp skips the row."""
    b = bounds.to(origins.dtype)
    x0, x1 = (b[None, :, c] + origins[:, 0:1] for c in (0, 1))
    y0, y1 = (b[None, :, c] + origins[:, 1:2] for c in (2, 3))
    xmin, xmax, ymin, ymax = (v[:, None, :] for v in box)
    return ((xmax < x0[..., None]) | (xmin > x1[..., None]) | (ymax < y0[..., None])
            | (ymin > y1[..., None]))


class CullStats(NamedTuple):
    """What the per-warp row cull of kernels 7 and 8 leaves to do."""

    visits: int  # (pixel, row) visits of the plain version, trigger included
    visits_left: int  # of those, the ones whose row the pixel's warp does not cull
    warp_rows: int  # (warp, row) pairs the warps reach before their pixels end
    warp_rows_culled: int  # of those, the ones the warp culls


def pair_cull_stats(win, counts, origins, tile_shape, visits,
                    tiles_per_step: int = 32) -> CullStats:
    """The cull's effect on dense windows (T, 12, K), from the plain
    version's visits (T, P) per pixel (``kernels.composite_plain_with_visits``):
    a pixel evaluates rows k < visits, and a warp reaches rows below the
    largest visits of its patch. A model of the kernels' schedule from
    ``kernels.row_pixel_box``; the kernels count nothing themselves."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    T, _, K = win.shape
    lay = pair_layout(tile_shape, win.device)
    npatch = lay.bounds.shape[0]
    n = torch.clamp(counts.long(), max=K)
    total = torch.zeros(4, dtype=torch.int64, device=win.device)
    for t0 in range(0, T, tiles_per_step):
        sl = slice(t0, min(T, t0 + tiles_per_step))
        miss = patch_misses(kn.row_pixel_box(win[sl].permute(1, 0, 2)), lay.bounds, origins[sl])
        live = torch.arange(K, device=win.device)[None, None, :] < n[sl, None, None]
        zero = torch.zeros(miss.shape[0], npatch, 1, dtype=torch.int64, device=win.device)
        keep = torch.cat([zero, torch.cumsum(~miss & live, 2)], 2)  # rows kept below k
        cull = torch.cat([zero, torch.cumsum(miss & live, 2)], 2)
        vis = visits[sl].long()
        reach = torch.zeros(vis.shape[0], npatch, dtype=torch.int64, device=win.device)
        reach.scatter_reduce_(1, lay.patch[None].expand_as(vis), vis, "amax")
        left = keep.flatten(1).gather(1, lay.patch[None] * (K + 1) + vis)
        total += torch.stack([vis.sum(), left.sum(), reach.sum(),
                              cull.gather(2, reach[..., None]).sum()])
    return CullStats(*(int(v) for v in total))


def pair_cull(tag: str, win, counts, origins, tile_shape, visits) -> None:
    """Logs what the per-warp row cull of kernels 7 and 8 leaves of a scene
    (its dense windows and the plain version's visits per pixel)."""
    st = pair_cull_stats(win, counts, origins, tile_shape, visits)
    log(f"[{tag}] pair-major cull: plain visits {st.visits}, left after the cull "
        f"{st.visits_left} ({st.visits_left / max(1, st.visits):.4f}); (warp, row) pairs "
        f"reached {st.warp_rows}, culled {st.warp_rows_culled} "
        f"({st.warp_rows_culled / max(1, st.warp_rows):.4f})")


def phase_kernels_random(device, T=510, K=1024, tile_shape=(32, 128), nx=15,
                         chunk=256) -> dict:
    """K1 and K2 against their plain versions, and against each other, on
    the same random scene (default: the 1080p tiling)."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    th, tw = tile_shape
    win, counts, origins = random_windows(T, K, (th, tw), nx, seed=1, device=device)
    bg = torch.tensor([1.0, 0.5, 0.25], device=device)
    out1 = kn.composite_tiles_fwd_cm(win, counts, origins, bg, (th, tw))
    ref1, visits = kn.composite_plain_with_visits(win, counts, origins, bg, (th, tw))
    rows, tid, flags = ragged_from_windows(win, counts, chunk)
    out2 = kn.composite_pairs_fwd_rg(rows, tid, flags, bg, 0.0, (th, tw), T, chunk, nx)
    ref2 = kn.composite_pairs_fwd_rg_plain(rows, tid, flags, bg, 0.0, (th, tw), T, chunk, nx)
    # the backward kernels on the same windows, with a random cotangent
    g = torch.Generator(device="cpu").manual_seed(2)
    g_full = torch.randn(out1.shape, generator=g).to(device)
    dwin = kn.composite_tiles_bwd_cm(win, counts, origins, bg, ref1, g_full, (th, tw))
    dwin_ref, stats = kn.composite_bwd_plain_with_stats(win, counts, origins, bg, ref1, g_full,
                                                        (th, tw))
    rg = (rows, tid, flags, bg, 0.0, ref2, g_full, (th, tw), T, chunk, nx)
    drows = kn.composite_pairs_bwd_rg(*rg)
    drows_ref = kn.composite_pairs_bwd_rg_plain(*rg)
    torch.cuda.synchronize() if device == "cuda" else None
    res = {
        "composite_tiles_fwd_cm": max_err(out1, ref1),
        "composite_pairs_fwd_rg": max_err(out2, ref2),
        "k1_vs_k2": max_err(out1, out2),
        "composite_tiles_bwd_cm": grad_rows(dwin, dwin_ref, 1),
        "composite_pairs_bwd_rg": grad_rows(drows, drows_ref, 0),
        "terminated_pixels": int((ref1[:, 4] > 1 - 1.01e-4).sum()),
        "visits": int(visits.sum()),
    }
    # rows past a tile's count, padding rows and invalid slots: exact zeros
    past = torch.arange(K, device=win.device)[None, :] >= counts[:, None]
    dead = rows[5] <= -1e9
    zeros_ok = (not bool(dwin.permute(0, 2, 1)[past].any()) and not bool(drows[:, dead].any())
                )
    log(f"[kernels/random] T={T} K={K} tile={th}x{tw} visits={res['visits']} "
        f"terminated_pixels={res['terminated_pixels']} backward visits={stats.visits} "
        f"hits={stats.hits}")
    for k in ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg", "k1_vs_k2"):
        log(f"[kernels/random] {k} max abs diff {res[k]} (limits {TOL})")
    for k in BWD_KERNELS:
        log_grad_rows("kernels/random", k, res[k])
    log(f"[kernels/random] backward: zeros where no row lives: {zeros_ok}")
    pair_cull("kernels/random", win, counts, origins, (th, tw), visits)
    res["ok"] = zeros_ok and all(within(res[k], TOL) for k in
                                 ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg", "k1_vs_k2"))
    res["ok"] &= all(res[k]["ok"] for k in BWD_KERNELS)
    rm = kernels_random_rm(win, counts, origins, bg, out1, (th, tw))
    res["ok"] &= rm.pop("ok")
    res.update(rm)
    return res


def kernels_random_rm(win, counts, origins, bg, full_cm, tile_shape) -> dict:
    """The four row-major kernels on the same random windows, repacked:
    forward against the plain versions (TOL), kernel 5 with origins against
    the channel-major kernel's output (accum + tfinal bg against full),
    kernel 3 against kernel 5 without origins bit for bit; backward under
    random g_accum AND g_tfinal, row by row (GRAD_TOL), with exact zeros in
    lanes 6-7 and in slots at or past each tile's count."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    T, _, K = win.shape
    P = tile_shape[0] * tile_shape[1]
    rows_g, packed, color = rm_rows_from_windows(win, origins)
    f3 = kn.composite_tiles_fwd_v2(packed, color, counts, tile_shape)
    f5 = kn.composite_tiles_fwd(packed, color, counts, tile_shape)
    f5o = kn.composite_tiles_fwd(rows_g, color, counts, tile_shape, origins)
    p3 = kn.composite_tiles_fwd_v2_plain(packed, color, counts, tile_shape)
    p5o = kn.composite_tiles_fwd_plain(rows_g, color, counts, tile_shape, origins)
    over_bg = torch.cat([f5o[0][..., 0:3] + f5o[1] * bg, f5o[0][..., 3:4], 1.0 - f5o[1]],
                        dim=2).permute(0, 2, 1)
    g = torch.Generator(device="cpu").manual_seed(3)
    g_accum = torch.randn(T, P, 4, generator=g).to(win.device)
    g_tfinal = torch.randn(T, P, 1, generator=g).to(win.device)
    cot = (g_accum, g_tfinal)
    # each backward gets its own forward's outputs
    b4 = kn.composite_tiles_bwd_v2(packed, color, counts, *cot, *f3, tile_shape)
    b6 = kn.composite_tiles_bwd(packed, color, counts, *cot, *f5, tile_shape)
    b6o = kn.composite_tiles_bwd(rows_g, color, counts, *cot, *f5o, tile_shape, origins)
    q4 = kn.composite_tiles_bwd_v2_plain(packed, color, counts, *cot, *p3, tile_shape)
    q6o = kn.composite_tiles_bwd_plain(rows_g, color, counts, *cot, *p5o, tile_shape, origins)
    if win.device.type == "cuda":
        torch.cuda.synchronize()
    res = {
        "composite_tiles_fwd_v2": rm_max_err(f3, p3),
        "composite_tiles_fwd": rm_max_err(f5o, p5o),
        "k5_origins_vs_k1": max_err(over_bg, full_cm),
        "composite_tiles_bwd_v2": rm_grad_rows(b4, q4),
        "composite_tiles_bwd": rm_grad_rows(b6o, q6o),
        "composite_tiles_bwd_packed": rm_grad_rows(b6, q4),
    }
    same = torch.equal(f3[0], f5[0]) and torch.equal(f3[1], f5[1])
    past = torch.arange(K, device=win.device)[None, :] >= counts[:, None]
    zeros_ok = not any(bool(x[past].any()) for pair in (b4, b6, b6o) for x in pair)
    for k in ("composite_tiles_fwd_v2", "composite_tiles_fwd", "k5_origins_vs_k1"):
        log(f"[kernels/random] {k} max abs diff {res[k]} (limits {TOL})")
    log(f"[kernels/random] composite_tiles_fwd_v2 == composite_tiles_fwd without origins, "
        f"bit for bit: {same}")
    for k, what in (("composite_tiles_bwd_v2", "packed rows"),
                    ("composite_tiles_bwd", "global rows + origins"),
                    ("composite_tiles_bwd_packed", "composite_tiles_bwd, packed rows")):
        log_grad_rows("kernels/random", f"{k} ({what})", res[k])
    log(f"[kernels/random] row-major backward: zeros in dead slots: {zeros_ok}")
    res["ok"] = (same and zeros_ok
                 and all(within(res[k], TOL) for k in
                         ("composite_tiles_fwd_v2", "composite_tiles_fwd", "k5_origins_vs_k1"))
                 and all(res[k]["ok"] for k in
                         ("composite_tiles_bwd_v2", "composite_tiles_bwd",
                          "composite_tiles_bwd_packed")))
    return res


# --------------------------------------------------------------------------
# phase 3: golden scenes
# --------------------------------------------------------------------------


def phase_goldens(device) -> bool:
    import glob

    import numpy as np
    import torch

    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, rasterize

    g_names = ("g_means3d", "g_scales", "g_quats", "g_opacities", "g_rgbs")

    def render_and_grads(d, s, dev):
        """Outputs and the input gradients of the goldens' fixed cotangent
        (tests/test_goldens.py:_loss), on device ``dev``."""
        H, W = int(d["H"]), int(d["W"])
        f = float(d["focal"])
        cam = Camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                     torch.tensor([f, f], device=dev),
                     torch.tensor([W / 2.0, H / 2.0], device=dev))
        args = [torch.from_numpy(d[k]).to(dev).requires_grad_(True)
                for k in ("means3d", "scales", "quats", "opacities", "rgbs")]
        o = rasterize(*args, torch.from_numpy(d["live"]).to(dev), cam, (H, W),
                      torch.from_numpy(d["bg"]).to(dev), s)
        wimg = (torch.arange(H * W * 3, dtype=torch.float32, device=dev).reshape(H, W, 3)
                % 7.0 + 1.0) / 7.0
        wd = (torch.arange(H * W, dtype=torch.float32, device=dev).reshape(H, W) % 5.0 + 1.0) / 5.0
        loss = ((o["img"] * wimg).sum() + (o["depth"] * wd).sum()
                + (o["mask"] * wd.T.reshape(H, W)).sum())
        return o, [g.cpu() for g in torch.autograd.grad(loss, args)]

    paths = sorted(glob.glob(os.path.join(REPO, "tests", "goldens", "scene*.npz")))
    ok = bool(paths)
    for p in paths:
        d = dict(np.load(p))
        # scene2's opaque front layer clamps alpha at 0.99. The goldens'
        # gradients come from autodiff, which is zero through the clamp; the
        # kernels keep renderCUDA's exp(q) there, so they are held to the
        # golden at the reference's kernel tolerance in that scene, and in
        # every scene to the plain backward (the same render on CPU tensors)
        g_tol = 2.5e-2 if os.path.basename(p) == "scene2.npz" else 1e-4
        for pm in (False, True):
            s = RasterizeSettings(tile_h=8, tile_w=128, max_per_tile=64, chunk=32, pair_major=pm)
            o, grads = render_and_grads(d, s, device)
            err = {k: float(np.abs(o[k].detach().cpu().numpy() - d[k]).max())
                   for k in ("img", "mask", "depth", "radius")}
            # the goldens were captured on a CPU; exp/log round differently here
            good = within(err, {"img": 5e-5, "mask": 5e-5, "depth": 1e-4, "radius": 0.0})
            _, cpu_grads = render_and_grads(d, s, "cpu")
            g_golden = max(scaled_err(g, torch.from_numpy(d[n])) for g, n in zip(grads, g_names))
            g_plain = max(scaled_err(g, c) for g, c in zip(grads, cpu_grads))
            good &= g_golden <= g_tol and g_plain <= 1e-4
            ok &= good
            log(f"[goldens] {os.path.basename(p)} pair_major={pm} max abs diff {err}; input "
                f"gradients, max scaled diff: vs golden {g_golden:.3e} (limit {g_tol}), vs the "
                f"plain backward on the CPU {g_plain:.3e} (limit 0.0001) "
                f"{'ok' if good else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase 4: the animate path at full width
# --------------------------------------------------------------------------


def build_avatar(device, rings=80, segs=130, triplane_ch=32, triplane_res=128,
                 num_poses=3, seed=0):
    """Synthetic full-width avatar with seeded random weights in a trained
    avatar's range, and ``num_poses`` seeded poses in camera coordinates."""
    import torch

    from exavatar_release_tpu_torch.avatar.config import AvatarConfig
    from exavatar_release_tpu_torch.avatar.human import HumanGaussians, init_human_buffers
    from exavatar_release_tpu_torch.avatar.param_dict import PosedSMPLXParams
    from exavatar_release_tpu_torch.models.smplx import (
        SMPLXIDInfo, build_prior, synthetic_smplx_assets,
    )

    g = torch.Generator(device="cpu").manual_seed(seed)
    prior = build_prior(synthetic_smplx_assets(
        rings=rings, segs=segs, num_shape=16, num_expr=50, device=device))
    a = prior.assets
    cfg = AvatarConfig(triplane_ch=triplane_ch, triplane_res=triplane_res)
    human = HumanGaussians(cfg, a.num_shape, a.num_joints, generator=g, device=device)
    with torch.no_grad():
        human.triplane.copy_(torch.randn(human.triplane.shape, generator=g))
        human.triplane_face.copy_(torch.randn(human.triplane_face.shape, generator=g))
        # a trained avatar's range: mm offsets, ~6 mm isotropic scales
        for net in (human.mean_offset_net, human.mean_offset_offset_net):
            net.linears[-1].weight.mul_(0.01)
            net.linears[-1].bias.mul_(0.01)
        for net, bias in ((human.scale_net, math.log(0.006)), (human.scale_offset_net, 0.0)):
            net.linears[-1].weight.mul_(0.05)
            net.linears[-1].bias.fill_(bias)
    buffers = init_human_buffers(prior)
    id_info = SMPLXIDInfo.zeros(a.num_shape, a.num_vertices, a.num_joints, device=device)
    n = lambda std, *s: (std * torch.randn(*s, generator=g)).to(device)
    poses = [
        PosedSMPLXParams(
            root_pose=torch.tensor([math.pi, 0.0, 0.0], device=device) + n(0.05, 3),
            body_pose=n(0.1, 21, 3), jaw_pose=n(0.05, 3),
            leye_pose=torch.zeros(3, device=device), reye_pose=torch.zeros(3, device=device),
            lhand_pose=n(0.1, 15, 3), rhand_pose=n(0.1, 15, 3), expr=n(0.5, a.num_expr),
            trans=torch.tensor([0.0, 0.1, 2.5], device=device) + n(0.02, 3),
        )
        for _ in range(num_poses)
    ]
    return prior, cfg, human, buffers, id_info, poses


def phase_animate(device, img=(1080, 1920), focal=1200.0, dense_k=16384, timing_iters=2,
                  **avatar_kw) -> dict:
    import torch

    from exavatar_release_tpu_torch.apps.animate import render_motion
    from exavatar_release_tpu_torch.avatar.human import human_forward
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import api
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    H, W = img
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    prior, cfg, human, buffers, id_info, poses = build_avatar(device, **avatar_kw)
    log(f"[animate] V={prior.assets.num_vertices} V_hr={prior.vertex_num_upsampled} "
        f"human Gaussians, image {W}x{H}, triplane {cfg.triplane_ch}x{cfg.triplane_res}")
    cam = Camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                 torch.tensor([focal, focal], device=device),
                 torch.tensor([W / 2.0, H / 2.0], device=device))
    cams = [cam] * len(poses)
    ragged = api.RasterizeSettings(pair_major=True)
    dense = api.RasterizeSettings(max_per_tile=dense_k)

    # the main path: every launch counter at 0 just before, read just after
    reset_launches()
    fr = render_motion(human, buffers, prior, id_info, poses, cams, cfg, ragged, (H, W))
    fd = render_motion(human, buffers, prior, id_info, poses, cams, cfg, dense, (H, W))
    sync()
    launches = read_launches()
    log(f"[animate] launches on the main path: {launches}")

    res = {"launches": launches, "ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[animate] {name}: {detail} {'ok' if cond else 'FAIL'}")

    for i, (r, d) in enumerate(zip(fr, fd)):
        mask = r["mask"]
        finite = all(bool(torch.isfinite(x[k]).all()) for x in (r, d) for k in ("img", "depth"))
        check(f"frame {i} finite", finite, "img/depth")
        cover = float((mask > 0.5).float().mean())
        check(f"frame {i} mask", 0.01 < cover < 0.9 and float(mask.max()) > 0.99,
              f"covered share {cover:.4f}, max {float(mask.max()):.4f}")
        check(f"frame {i} n_dropped_pairs", int(r["n_dropped_pairs"]) == 0,
              f"ragged {int(r['n_dropped_pairs'])}")
        check(f"frame {i} dense n_truncated", int(d["n_truncated"]) == 0,
              f"{int(d['n_truncated'])} at max_per_tile={dense_k}, "
              f"max tile count {int(d['tile_counts'].max())}, live pairs {int(d['tile_counts'].sum())}")
        diff = max(float((r[k] - d[k]).abs().max()) for k in ("img", "depth", "mask"))
        # the two runs recompute human_forward, whose normals sum by atomics
        check(f"frame {i} dense vs ragged", diff <= 1e-5, f"max abs diff {diff}")
    for k in FWD_KERNELS:
        check(f"{k} launched", launches[k] == len(poses), f"{launches[k]} launches")
    # serving runs under no_grad: no backward, nothing saved; and no row-major kernel
    for k in BWD_KERNELS + RM_FWD_KERNELS + RM_BWD_KERNELS:
        check(f"{k} not launched", launches[k] == 0, f"{launches[k]} launches")

    # both kernels against their plain versions on frame 0's own inputs
    bg = torch.ones(3, device=device)
    with torch.no_grad():
        a = human_forward(human, buffers, prior, poses[0], id_info, cam.R, cam.t, cfg).assets_refined
        args = (a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam, (H, W))
        ind = api.prepare(*args, dense)
        inr = api.prepare(*args, ragged)
        out1 = api.composite(ind, bg, dense)
        out2 = api.composite(inr, bg, ragged)
        b = ind.binning
        ref1, visits = kn.composite_plain_with_visits(ind.rows, b.tile_counts, ind.origins,
                                                      bg, ind.tile_shape)
        ny, nx = inr.binning.num_tiles
        rg = (inr.rows, inr.binning.tid, inr.binning.flags, bg, 0.0, inr.tile_shape,
              ny * nx, inr.chunk, nx)
        ref2 = kn.composite_pairs_fwd_rg_plain(*rg)
        sync()
        err1, err2 = max_err(out1, ref1), max_err(out2, ref2)
        check("composite_tiles_fwd_cm vs plain (frame 0)", within(err1, TOL), f"{err1}")
        check("composite_pairs_fwd_rg vs plain (frame 0)", within(err2, TOL), f"{err2}")
        # the window kernel (kernel 11) on this frame's sorted pairs
        ok_w, detail = windows_on_binning(ind.screen, (H, W), ind.tile_shape, dense_k, b,
                                          dense.pairs_per_gaussian * a.mean_3d.shape[0])
        check("tile_windows on frame 0's binning", ok_w, detail)

        live_rows = int(torch.clamp(b.tile_counts.long(), max=ind.rows.shape[2]).sum())
        T, P = out1.shape[0], out1.shape[2]
        n_visits = int(visits.sum())
        ops_s = n_visits * OPS_PER_VISIT / PEAK_F32_FLOPS
        bytes_s = (live_rows * BYTES_PER_ROW + T * P * BYTES_PER_PIXEL + T * 12) / PEAK_BYTES
        bound_ms = 1e3 * max(ops_s, bytes_s)
        bound_by = "operations" if ops_s >= bytes_s else "bytes"
        log(f"[animate] frame 0: live pairs {live_rows}, pixel-Gaussian visits {n_visits}, "
            f"Pa {inr.rows.shape[1]}, bound {bound_ms:.6f} ms by {bound_by} "
            f"(ops {1e3 * ops_s:.6f} ms, bytes {1e3 * bytes_s:.6f} ms)")
        pair_cull("animate", ind.rows, b.tile_counts, ind.origins, ind.tile_shape, visits)

        stats = {}
        if device == "cuda":
            da = (ind.rows, b.tile_counts, ind.origins, bg, ind.tile_shape)
            f1 = lambda: kn.composite_tiles_fwd_cm(*da)
            f2 = lambda: kn.composite_pairs_fwd_rg(*rg)
            cuda_ms(f1, 3), cuda_ms(f2, 3)  # warm-up
            ms = {"composite_tiles_fwd_cm": cuda_ms(f1, 20),
                  "composite_pairs_fwd_rg": cuda_ms(f2, 20)}
            plain = {
                "composite_tiles_fwd_cm": cuda_ms(lambda: kn.composite_tiles_fwd_cm_plain(*da), 1),
                "composite_pairs_fwd_rg": cuda_ms(lambda: kn.composite_pairs_fwd_rg_plain(*rg), 1),
            }
            for k, e in (("composite_tiles_fwd_cm", err1), ("composite_pairs_fwd_rg", err2)):
                stats[k] = {"ms": ms[k], "plain_ms": plain[k], "bound_ms": bound_ms,
                            "bound_by": bound_by, "max_abs_err": max(e.values())}
                log(f"[animate] {k}: {ms[k]:.4f} ms, plain {plain[k]:.2f} ms, "
                    f"bound {bound_ms:.6f} ms ({bound_by})")
        res["kernel_stats"] = stats

        # per-frame split after warm-up
        for name, s in (("pair_major", ragged), ("dense", dense)):
            t_h = t_p = t_c = 0.0
            for it in range(timing_iters + 1):
                for pose in poses:
                    sync()
                    t0 = time.perf_counter()
                    hout = human_forward(human, buffers, prior, pose, id_info, cam.R, cam.t, cfg)
                    sync()
                    t1 = time.perf_counter()
                    aa = hout.assets_refined
                    inp = api.prepare(aa.mean_3d, aa.scale, aa.rotation, aa.opacity, aa.rgb,
                                      aa.live, cam, (H, W), s)
                    sync()
                    t2 = time.perf_counter()
                    api.composite(inp, bg, s)
                    sync()
                    t3 = time.perf_counter()
                    if it:  # iteration 0 warms up
                        t_h, t_p, t_c = t_h + t1 - t0, t_p + t2 - t1, t_c + t3 - t2
            nf = timing_iters * len(poses)
            split = {"human_forward_ms": 1e3 * t_h / nf, "project_bin_ms": 1e3 * t_p / nf,
                     "composite_ms": 1e3 * t_c / nf}
            split["frame_ms"] = sum(split.values())
            res[f"frame_{name}"] = split
            log(f"[animate] {name} per-frame ms over {nf} frames: {split}")
        if device == "cuda":
            res["profile"] = profile_frame(lambda: render_motion(
                human, buffers, prior, id_info, poses[:1], cams[:1], cfg, ragged, (H, W)))
    return res


# --------------------------------------------------------------------------
# phase 5: the differentiable frame at full width
# --------------------------------------------------------------------------


def build_frame(device, img=(1080, 1920), focal=1200.0, scene_capacity=1 << 15,
                scene_live=20000, tex=256, lpips_net="vgg", seed=0, **avatar_kw):
    """The full-width training setup: the avatar of ``build_avatar`` as
    ``AvatarTrainables`` with its per-frame poses in the 6D store, a scene of
    ``scene_live`` Gaussians from a seeded point cloud scattered around and
    behind the subject, LPIPS with seeded random weights, a seeded face
    texture and one seeded training frame."""
    import torch

    from exavatar_release_tpu_torch.apps.common import synthetic_face_mesh
    from exavatar_release_tpu_torch.avatar import scene as sc
    from exavatar_release_tpu_torch.avatar.model import AvatarTrainables, FrameData, build_statics
    from exavatar_release_tpu_torch.avatar.param_dict import init_param_frames
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.lpips import VGG16_PLAN, LPIPSParams
    from exavatar_release_tpu_torch.train.loop import ModelBundle

    H, W = img
    prior, cfg, human, buffers, id_info, poses = build_avatar(device, num_poses=2, seed=seed,
                                                              **avatar_kw)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(*s, generator=g)).to(device)
    a = prior.assets

    # synthetic face mesh: the faces wholly inside the face region, over
    # face_vertex_idx order, with a planar UV from the template
    statics = build_statics(prior, buffers, *synthetic_face_mesh(prior))

    xyz = torch.stack([u(-6, 6, scene_live), u(-3, 4, scene_live), u(2, 10, scene_live)], dim=1)
    state = sc.init_from_point_cloud(xyz, u(0, 1, scene_live, 3), torch.zeros(3, device=device),
                                     6.0, scene_capacity)
    frames = init_param_frames(
        [{k: getattr(p, k).cpu().numpy() for k in
          ("root_pose", "body_pose", "jaw_pose", "leye_pose", "reye_pose", "lhand_pose",
           "rhand_pose", "expr", "trans")} for p in poses], device=device)
    trainables = AvatarTrainables(state.params, human, frames)

    # LPIPS: architecture-correct, He-normal convolutions, small positive heads
    if lpips_net == "vgg":
        shapes, cin = [], 3
        for ch, n_layers in VGG16_PLAN:
            for _ in range(n_layers):
                shapes.append((ch, cin, 3, 3))
                cin = ch
        tap_dims = [ch for ch, _ in VGG16_PLAN]
    else:
        shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
                  (256, 256, 3, 3)]
        tap_dims = [64, 192, 384, 256, 256]
    n = lambda *sh: torch.randn(*sh, generator=g).to(device)
    lpips = LPIPSParams(
        tuple(n(*sh) * (2.0 / (sh[1] * sh[2] * sh[3])) ** 0.5 for sh in shapes),
        tuple(torch.zeros(sh[0], device=device) for sh in shapes),
        tuple(torch.relu(n(d)) * 0.1 + 0.01 for d in tap_dims), lpips_net)

    bundle = ModelBundle(
        buffers=buffers, prior=prior, statics=statics, id_info=id_info, lpips=lpips,
        face_texture=u(0, 1, 3, tex, tex), face_texture_mask=torch.ones(1, tex, tex, device=device),
        init_joint_offset=torch.zeros(a.num_joints, 3, device=device))
    mask = torch.zeros(1, H, W, device=device)
    mask[:, H // 6: 5 * H // 6, W // 3: 2 * W // 3] = 1.0
    frame = FrameData(
        img=u(0, 1, 3, H, W), mask=mask,
        bbox=torch.tensor([W * 0.33, H * 0.16, W * 0.33, H * 0.68], device=device),
        cam=Camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                   torch.tensor([focal, focal], device=device),
                   torch.tensor([W / 2.0, H / 2.0], device=device)),
        frame_row=0)
    bg = u(0, 1, 3)
    return cfg, trainables, state.aux, bundle, frame, bg


def find_capacities(trainables, scene_aux, bundle, frame, cfg, tag, frame_row=0):
    """The pair budget and the dense window width at which this frame's
    largest render (scene + refined human) loses no pair: (pairs_per_gaussian,
    max_per_tile rounded up to 256, (scene, human, scene+human assets))."""
    import torch

    from exavatar_release_tpu_torch.avatar import scene as sc
    from exavatar_release_tpu_torch.avatar.gaussians import concat_assets
    from exavatar_release_tpu_torch.avatar.human import human_forward
    from exavatar_release_tpu_torch.ops.rasterizer import api

    H, W = frame.img.shape[1:]
    with torch.no_grad():
        cam = frame.cam
        s_asset = sc.scene_assets(sc.SceneState(trainables.scene, scene_aux), cam.R, cam.t)
        h_asset = human_forward(trainables.human, bundle.buffers, bundle.prior,
                                trainables.frames.lookup(frame_row), bundle.id_info, cam.R, cam.t,
                                cfg).assets_refined
        both = concat_assets(s_asset, h_asset)
        ppg, max_count = 16, 0
        while True:
            probe = api.RasterizeSettings(pair_major=True, pairs_per_gaussian=ppg)
            drops = 0
            for a in (s_asset, h_asset, both):
                b = api.prepare(a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam,
                                (H, W), probe).binning
                drops += int(b.n_dropped_pairs)
                max_count = max(max_count, int(b.tile_counts.max()))
                pairs = int(b.tile_counts.sum())
            if drops == 0 or ppg >= 256:
                break
            ppg *= 2
        dense_k = -(-max_count // 256) * 256
    log(f"[{tag}] capacities: pairs_per_gaussian={ppg}, dense max_per_tile={dense_k} "
        f"(largest tile holds {max_count}; scene+human render has {pairs} live pairs)")
    return ppg, dense_k, (s_asset, h_asset, both)


def phase_frame(device, timing_iters=2, **setup_kw) -> dict:
    import torch

    from exavatar_release_tpu_torch.avatar import scene as sc
    from exavatar_release_tpu_torch.avatar.gaussians import concat_assets
    from exavatar_release_tpu_torch.avatar.human import human_forward
    from exavatar_release_tpu_torch.avatar.model import forward_frame
    from exavatar_release_tpu_torch.ops.rasterizer import api
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
    from exavatar_release_tpu_torch.train.loop import loss_and_grads

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    cfg, trainables, scene_aux, bundle, frame, bg = build_frame(device, **setup_kw)
    H, W = frame.img.shape[1:]
    C = trainables.scene.mean.shape[0]
    log(f"[frame] setup {time.perf_counter() - t0:.1f} s: scene {int(scene_aux.live.sum())} live "
        f"of {C}, human {bundle.prior.vertex_num_upsampled}, image {W}x{H}, LPIPS "
        f"{bundle.lpips.net}, bg {[round(float(x), 4) for x in bg]}")
    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[frame] {name}: {detail} {'ok' if cond else 'FAIL'}")

    cam = frame.cam
    ppg, dense_k, (s_asset, h_asset, both) = find_capacities(trainables, scene_aux, bundle, frame,
                                                             cfg, "frame")
    ragged = api.RasterizeSettings(pair_major=True, pairs_per_gaussian=ppg)
    dense = api.RasterizeSettings(max_per_tile=dense_k, pairs_per_gaussian=ppg)

    b = bundle
    fwd_args = (trainables, scene_aux, b.buffers, b.prior, b.statics, b.id_info, b.lpips,
                b.face_texture, b.face_texture_mask, b.init_joint_offset, frame, bg, cfg)

    # ---- the main path: one test-mode frame, then loss_and_grads in both
    # modes, every launch counter at 0 just before and read just after
    reset_launches()
    with torch.no_grad():
        test_out = forward_frame(*fwd_args, is_warmup=False, mode="test", settings=ragged)
    sync()
    launches = {"test": read_launches()}
    runs = {}
    for name, s in (("pair_major", ragged), ("dense", dense)):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        runs[name] = loss_and_grads(trainables, scene_aux, bundle, frame, bg, cfg,
                                    is_warmup=False, settings=s)
        sync()
        launches[name] = read_launches()
        if on_card:
            res[f"peak_bytes_{name}"] = torch.cuda.max_memory_allocated()
            log(f"[frame] {name}: peak memory allocated "
                f"{res[f'peak_bytes_{name}'] / 2**30:.3f} GiB")
    res["launches"] = launches
    log(f"[frame] launches on the main path: {launches}")
    expect = {
        "test": {"composite_pairs_fwd_rg": 5},
        "pair_major": {"composite_pairs_fwd_rg": 5, "composite_pairs_bwd_rg": 5},
        "dense": {"composite_tiles_fwd_cm": 5, "composite_tiles_bwd_cm": 5},
    }
    for path, want in expect.items():
        # CPU tensors (a rehearsal) run the plain versions and launch nothing
        want = {k: want.get(k, 0) if on_card else 0 for k in ALL_KERNELS}
        check(f"launches of {path}", launches[path] == want, f"{launches[path]}")

    for k in ("scene_img", "human_img", "scene_human_img", "human_img_refined",
              "scene_human_img_refined", "scene_human_img_composed",
              "scene_human_img_refined_composed", "human_face_img", "human_face_img_refined"):
        r = test_out.renders[k]
        check(f"test-mode {k}", tuple(r.shape) == (H, W, 3) and bool(torch.isfinite(r).all()),
              f"shape {tuple(r.shape)}")
    cover = float((test_out.renders["human_mask"] > 0.5).float().mean())
    face = float((test_out.renders["face_render"][:3] != -1).any(0).float().mean())
    check("test-mode coverage", 0.01 < cover < 0.9 and face > 0,
          f"human covers {cover:.4f} of the frame, the face mesh {face:.5f}")

    for name, (total, out, grads, g2d) in runs.items():
        finite = all(bool(torch.isfinite(v)) for v in out.losses.values())
        check(f"{name} losses", finite and len(out.losses) == 22,
              f"total {float(total):.6f}, {len(out.losses)} terms")
        gfin = all(bool(torch.isfinite(g).all()) for g in grads.values()) \
            and bool(torch.isfinite(g2d).all())
        reach = all(float(grads[k].abs().max()) > 0 for k in
                    ("scene.mean", "scene.opacity", "human.triplane", "human.shape_param",
                     "human.joint_offset", "frames.body_pose", "frames.trans"))
        check(f"{name} gradients", gfin and reach and float(g2d.abs().max()) > 0,
              f"{len(grads)} leaves finite, scene / human / frames reached, "
              f"max |g_mean2d| {float(g2d.abs().max()):.3e}")
        check(f"{name} capacities", int(out.raster_dropped_pairs) == 0
              and int(out.raster_truncated) == 0,
              f"n_dropped_pairs {int(out.raster_dropped_pairs)}, "
              f"n_truncated {int(out.raster_truncated)}")
    (tot_r, out_r, g_r, m_r), (tot_d, out_d, g_d, m_d) = runs["pair_major"], runs["dense"]
    rel = abs(float(tot_r) - float(tot_d)) / abs(float(tot_d))
    check("dense vs pair-major total", rel <= 1e-5, f"relative diff {rel:.3e}")
    worst = max(((k, own_scale_err(g_r[k], g_d[k])) for k in g_r), key=lambda kv: kv[1])
    m_err = own_scale_err(m_r, m_d)
    # the two runs recompute human_forward (atomics in the normals) and sum
    # the backward kernels' partial sums in another order
    check("dense vs pair-major gradients", worst[1] <= 1e-3 and m_err <= 1e-3,
          f"worst leaf {worst[0]} {worst[1]:.3e}, g_mean2d {m_err:.3e} (each of its own "
          f"max |dense|, limit 1e-3)")
    res["losses"] = {k: float(v) for k, v in out_r.losses.items()}
    log(f"[frame] losses (pair-major): {res['losses']}")

    # ---- the backward kernels against their plain versions on this frame's
    # largest render (scene + refined human); the whole windows are compared,
    # row by row. The cotangent is what an L1 image loss, a mask mean and a
    # depth mean send back: the frame's own losses read no depth, which would
    # leave the ddepth row zero and unchecked
    with torch.no_grad():
        args = (both.mean_3d, both.scale, both.rotation, both.opacity, both.rgb, both.live, cam,
                (H, W))
        ind, inr = api.prepare(*args, dense), api.prepare(*args, ragged)
        ones = torch.ones(3, device=device)
        full_d = api.composite(ind, ones, dense)
        full_r = api.composite(inr, ones, ragged)
    th, tw = ind.tile_shape
    ny, nx = ind.binning.num_tiles
    leaf = full_d.clone().requires_grad_(True)
    image = (leaf.reshape(ny, nx, 5, th, tw).permute(0, 3, 1, 4, 2)
             .reshape(ny * th, nx * tw, 5)[:H, :W])
    loss = ((image[..., 0:3] - frame.img.permute(1, 2, 0)).abs().mean() + image[..., 4].mean()
            + image[..., 3].mean())
    g_full = torch.autograd.grad(loss, leaf)[0].contiguous()
    bd = ind.binning
    dense_args = (ind.rows, bd.tile_counts, ind.origins, ones, full_d, g_full, ind.tile_shape)
    rg_args = (inr.rows, inr.binning.tid, inr.binning.flags, ones, 0.0, full_r, g_full,
               inr.tile_shape, ny * nx, inr.chunk, nx)
    dwin = kn.composite_tiles_bwd_cm(*dense_args)
    drows = kn.composite_pairs_bwd_rg(*rg_args)
    t0 = time.perf_counter()
    dwin_ref, stats = kn.composite_bwd_plain_with_stats(*dense_args)
    sync()
    plain_dense_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    drows_ref = kn.composite_pairs_bwd_rg_plain(*rg_args)
    sync()
    plain_rg_ms = 1e3 * (time.perf_counter() - t0)
    err = {"composite_tiles_bwd_cm": grad_rows(dwin, dwin_ref, 1),
           "composite_pairs_bwd_rg": grad_rows(drows, drows_ref, 0)}
    for k, e in err.items():
        res["ok"] &= e["ok"]
        log_grad_rows("frame", f"{k} (scene+human render)", e)
    check("dense vs pair-major forward", float((full_d - full_r).abs().max()) <= 1e-6,
          f"max abs diff {float((full_d - full_r).abs().max())}")
    _, visits = kn.composite_plain_with_visits(ind.rows, bd.tile_counts, ind.origins, ones,
                                               ind.tile_shape)
    pair_cull("frame", ind.rows, bd.tile_counts, ind.origins, ind.tile_shape, visits)
    del visits

    # bound of the backward: operations of the replay against the bytes
    live_rows = int(torch.clamp(bd.tile_counts.long(), max=ind.rows.shape[2]).sum())
    T, P = full_d.shape[0], full_d.shape[2]
    ops_s = (stats.visits * OPS_PER_VISIT + stats.hits * OPS_PER_HIT) / PEAK_F32_FLOPS
    stat = {}
    for k, out_bytes, plain_ms in (
            ("composite_tiles_bwd_cm", dwin.numel() * 4, plain_dense_ms),
            ("composite_pairs_bwd_rg", drows.numel() * 4, plain_rg_ms)):
        bytes_s = (live_rows * BYTES_PER_ROW + T * P * BWD_BYTES_PER_PIXEL + out_bytes) / PEAK_BYTES
        stat[k] = {"bound_ms": 1e3 * max(ops_s, bytes_s),
                   "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                   "plain_ms": plain_ms, "max_abs_err": err[k]["max_abs_err"],
                   "max_row_rel_err": err[k]["max_row_rel_err"]}
        log(f"[frame] {k} bound {stat[k]['bound_ms']:.6f} ms by {stat[k]['bound_by']} (ops "
            f"{1e3 * ops_s:.6f} ms from {stats.visits} visits x {OPS_PER_VISIT} + {stats.hits} "
            f"hits x {OPS_PER_HIT}; bytes {1e3 * bytes_s:.6f} ms from {live_rows} live rows, "
            f"{T * P} pixels, {out_bytes} output bytes)")
    if on_card:
        fd = lambda: kn.composite_tiles_bwd_cm(*dense_args)
        fr = lambda: kn.composite_pairs_bwd_rg(*rg_args)
        cuda_ms(fd, 2), cuda_ms(fr, 2)  # warm-up
        stat["composite_tiles_bwd_cm"]["ms"] = cuda_ms(fd, 10)
        stat["composite_pairs_bwd_rg"]["ms"] = cuda_ms(fr, 10)
        fwd_ms = {"composite_tiles_fwd_cm": cuda_ms(lambda: api.composite(ind, ones, dense), 10),
                  "composite_pairs_fwd_rg": cuda_ms(lambda: api.composite(inr, ones, ragged), 10)}
        for k in BWD_KERNELS:
            log(f"[frame] {k}: {stat[k]['ms']:.4f} ms, plain {stat[k]['plain_ms']:.2f} ms, "
                f"bound {stat[k]['bound_ms']:.6f} ms ({stat[k]['bound_by']})")
        log(f"[frame] forward kernels on the same render: {fwd_ms}")
    res["kernel_stats"] = stat
    del dwin, drows, dwin_ref, drows_ref, ind, inr, full_d, full_r, g_full, leaf, image

    # ---- timing: forward and backward of one train-mode frame
    if on_card:
        from exavatar_release_tpu_torch.avatar.model import total_loss

        for name, s in (("pair_major", ragged), ("dense", dense)):
            t_f = t_b = 0.0
            for it in range(timing_iters + 1):
                params = tuple(trainables.parameters())
                off = torch.zeros(C, 2, device=device, requires_grad=True)
                sync()
                t0 = time.perf_counter()
                out = forward_frame(*fwd_args, is_warmup=False, mode="train", settings=s,
                                    scene_mean2d_offset=off)
                tot = total_loss(out.losses)
                sync()
                t1 = time.perf_counter()
                torch.autograd.grad(tot, params + (off,), allow_unused=True)
                sync()
                t2 = time.perf_counter()
                del out, tot
                if it:  # iteration 0 warms up
                    t_f, t_b = t_f + t1 - t0, t_b + t2 - t1
            split = {"forward_ms": 1e3 * t_f / timing_iters, "backward_ms": 1e3 * t_b / timing_iters}
            split["loss_and_grads_ms"] = sum(split.values())
            res[f"step_{name}"] = split
            log(f"[frame] {name} per train-mode frame over {timing_iters} runs: {split}")
        res["profile"] = profile_frame(
            lambda: loss_and_grads(trainables, scene_aux, bundle, frame, bg, cfg,
                                   is_warmup=False, settings=ragged),
            top=16, what="one pair-major loss_and_grads")
    return res


# --------------------------------------------------------------------------
# phase 6: the trainer at full width
# --------------------------------------------------------------------------


def phase_train(device, steps=4, timing_iters=2, grow_to=1 << 16, start_kw=None,
                governor_kw=None, v2_leaf_tol=V2_LEAF_TOL, **setup_kw) -> dict:
    """``start_kw`` / ``governor_kw``: the trainer's first ``RasterizeSettings``
    and the governor's options, for a rehearsal at a tiny size (the defaults
    are a user's); ``v2_leaf_tol`` likewise (an image of a few thousand pixels
    moves a leaf by percents when one threshold flips)."""
    import copy
    import dataclasses
    import tempfile

    import torch

    from exavatar_release_tpu_torch.apps.train import train_loop
    from exavatar_release_tpu_torch.avatar import convert
    from exavatar_release_tpu_torch.avatar import scene as sc
    from exavatar_release_tpu_torch.ops.rasterizer import api
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
    from exavatar_release_tpu_torch.train import loop as tl
    from exavatar_release_tpu_torch.train.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    from exavatar_release_tpu_torch.train.optim import make_optimizer

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, trainables, scene_aux, bundle, frame, bg = build_frame(device, **setup_kw)
    cfg = dataclasses.replace(cfg, end_epoch=3)
    frames = [frame, frame._replace(frame_row=1)]
    H, W = frame.img.shape[1:]
    res = {"ok": True, "launches": {}}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[train] {name}: {detail} {'ok' if cond else 'FAIL'}")

    def expect_launches(path, want):
        got = res["launches"][path]
        want = {k: want.get(k, 0) if on_card else 0 for k in ALL_KERNELS}
        check(f"launches of {path}", got == want, f"{got}")

    def finite(state, losses):
        return (all(bool(torch.isfinite(v).all()) for v in losses.values())
                and all(bool(torch.isfinite(p).all()) for p in state.trainables.parameters()))

    tot_itr = cfg.end_epoch * len(frames)
    opt = make_optimizer(trainables, cfg, float(scene_aux.cam_dist_radius), tot_itr)
    state = tl.init_train_state(trainables, scene_aux, opt)

    # ---- 1. the trainer from the default settings, as a user's run starts:
    # the governor must end in pair-major compositing and lose no pair
    growths = []
    gov = tl.RasterCapacityGovernor(
        api.RasterizeSettings(**(start_kw or {})), patience=1,
        log=lambda m: (growths.append(m), log(f"[train] governor: {m}")), **(governor_kw or {}))
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    reset_launches()
    t0 = time.perf_counter()
    run = train_loop(state, bundle, frames, opt, cfg, governor=gov, model_dir=model_dir, seed=0)
    sync()
    res["launches"]["train"] = read_launches()
    state = run.state
    hist = run.history
    log(f"[train] train_loop: {len(hist)} steps in {time.perf_counter() - t0:.2f} s, totals "
        f"{[round(h['total'], 4) for h in hist]}, truncated "
        f"{[int(h['raster_truncated']) for h in hist]}, dropped pairs "
        f"{[int(h['raster_dropped_pairs']) for h in hist]}")
    n_dense = sum(1 for m in growths if "max_per_tile" in m)  # steps before the switch
    check("governor", run.settings.pair_major and hist[-1]["raster_truncated"] == 0
          and hist[-1]["raster_dropped_pairs"] == 0 and len(growths) >= 1,
          f"{len(growths)} growths, ends with {run.settings}")
    expect_launches("train", {
        "composite_tiles_fwd_cm": 5 * n_dense, "composite_tiles_bwd_cm": 5 * n_dense,
        "composite_pairs_fwd_rg": 5 * (len(hist) - n_dense),
        "composite_pairs_bwd_rg": 5 * (len(hist) - n_dense)})
    check("train_loop state", state.itr == len(hist) == tot_itr and state.opt_state.count == tot_itr
          and latest_checkpoint(model_dir) is not None
          and latest_checkpoint(model_dir).endswith(f"snapshot_{cfg.end_epoch - 1}.npz"),
          f"itr {state.itr}, step count {state.opt_state.count}, newest snapshot "
          f"{os.path.basename(latest_checkpoint(model_dir) or '-')}")
    settings = run.settings

    # ---- 2. further steps on one frame with a fixed background
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    totals, step_ms = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state, losses = tl.train_step(state, bundle, frame, opt, cfg,
                                      is_warmup=cfg.is_warmup(state.itr), settings=settings, bg=bg)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        totals.append(float(losses["total"]))
        res["ok"] &= finite(state, losses)
    check("steps on one frame", totals[-1] < totals[0] and state.itr == tot_itr + steps
          and float(state.scene_aux.track_cnt.sum()) > 0 and res["ok"],
          f"totals {[round(x, 5) for x in totals]}, itr {state.itr}, tracked rows "
          f"{int((state.scene_aux.track_cnt > 0).sum())}, every loss and parameter finite")
    if on_card:
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[train] peak memory allocated over {steps} steps "
            f"{res['peak_bytes'] / 2**30:.3f} GiB")
    # the split of a step, on a copy (the pieces advance the state they get)
    probe = copy.deepcopy(state)
    t_lg = t_up = t_ts = 0.0
    for it in range(timing_iters + 1):
        sync()
        t0 = time.perf_counter()
        _, out, grads, g2d = tl.loss_and_grads(probe.trainables, probe.scene_aux, bundle, frame,
                                               bg, cfg, cfg.is_warmup(probe.itr), False, settings)
        sync()
        t1 = time.perf_counter()
        opt.update(grads, probe.opt_state, probe.trainables)
        sync()
        t2 = time.perf_counter()
        sc.track_stats(sc.SceneState(probe.trainables.scene, probe.scene_aux), g2d,
                       out.scene_is_vis, out.scene_radius, img_shape=(H, W))
        sync()
        t3 = time.perf_counter()
        if it:  # iteration 0 warms up
            t_lg, t_up, t_ts = t_lg + t1 - t0, t_up + t2 - t1, t_ts + t3 - t2
    n = max(timing_iters, 1)
    res["step_split"] = {"train_step_ms": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
                         "loss_and_grads_ms": 1e3 * t_lg / n, "optimizer_update_ms": 1e3 * t_up / n,
                         "track_stats_ms": 1e3 * t_ts / n}
    log(f"[train] per step ({'pair-major' if settings.pair_major else 'dense'}): "
        f"{res['step_split']}")
    if on_card:
        res["profile"] = profile_frame(
            lambda: tl.train_step(probe, bundle, frame, opt, cfg, is_warmup=False,
                                  settings=settings, bg=bg),
            top=12, what="one pair-major train_step")
    del probe, out, grads, g2d

    # ---- 3. the same step through kernel_v=2, from the state those steps left
    ppg, dense_k, (_, _, both) = find_capacities(state.trainables, state.scene_aux, bundle, frame,
                                                 cfg, "train")
    v1 = api.RasterizeSettings(max_per_tile=dense_k, pairs_per_gaussian=ppg)
    v2 = dataclasses.replace(v1, kernel_v=2)
    lg = lambda s: tl.loss_and_grads(state.trainables, state.scene_aux, bundle, frame, bg, cfg,
                                     False, False, s)
    tot1, out1, g1, m1 = lg(v1)
    tot2, out2, g2, m2 = lg(v2)
    rel = abs(float(tot2) - float(tot1)) / abs(float(tot1))
    leaf_err = {k: own_scale_err(g2[k], g1[k]) for k in g1}
    worst = max(leaf_err.items(), key=lambda kv: kv[1])
    m_err = own_scale_err(m2, m1)
    # the same two evaluations again: how far each path is from itself, run
    # to run (the backward kernels and index_add_ sum with atomics)
    again = {"kernel_v=1": (g1, lg(v1)[2]), "kernel_v=2": (g2, lg(v2)[2])}
    spread = {n: {k: own_scale_err(b[k], a[k]) for k in a} for n, (a, b) in again.items()}
    del again
    over = sorted(((k, e) for k, e in leaf_err.items() if e > 1e-3), key=lambda kv: -kv[1])
    log(f"[train] kernel_v=2 vs kernel_v=1, leaves over 1e-3 of their own max ({len(over)} of "
        f"{len(leaf_err)}): " + ", ".join(
            f"{k} {e:.2e} (max |g| {float(g1[k].abs().max()):.2e}; run to run: v1 "
            f"{spread['kernel_v=1'][k]:.1e}, v2 {spread['kernel_v=2'][k]:.1e})" for k, e in over))
    for n, sp in spread.items():
        k = max(sp, key=sp.get)
        log(f"[train] {n} against itself, run to run: worst leaf {k} {sp[k]:.3e} of its own max")
    check("kernel_v=2 vs kernel_v=1 (dense) from the same state",
          rel <= 1e-4 and worst[1] <= v2_leaf_tol and m_err <= 1e-3
          and int(out2.raster_truncated) == int(out2.raster_dropped_pairs) == 0,
          f"totals {float(tot2):.6f} vs {float(tot1):.6f} (relative {rel:.2e}, limit 1e-4); "
          f"worst gradient leaf {worst[0]} {worst[1]:.3e} of its own max (limit {v2_leaf_tol}), "
          f"g_mean2d {m_err:.3e} (limit 1e-3); nothing truncated at max_per_tile={dense_k}")
    del out1, out2, g1, g2
    fork = copy.deepcopy(state)
    reset_launches()
    v2_ms = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        fork, losses = tl.train_step(fork, bundle, frame, opt, cfg, is_warmup=False, settings=v2,
                                     bg=bg)
        sync()
        v2_ms.append(1e3 * (time.perf_counter() - t0))
        res["ok"] &= finite(fork, losses)
    res["launches"]["train_v2"] = read_launches()
    expect_launches("train_v2", {"composite_tiles_fwd_v2": 10, "composite_tiles_bwd_v2": 10})
    log(f"[train] kernel_v=2 train_step ms: {[round(x, 2) for x in v2_ms]}")
    res["train_v2_step_ms"] = v2_ms[-1]
    del fork

    # kernels 3-6 against their plain versions on that step's scene + human
    # windows, under the cotangents an L1 image loss over the background, a
    # mask mean and a depth mean send back (accum AND tfinal get one)
    with torch.no_grad():
        args = (both.mean_3d, both.scale, both.rotation, both.opacity, both.rgb, both.live,
                frame.cam, (H, W))
        in1, in2 = api.prepare(*args, v1), api.prepare(*args, v2)
    counts, origins, tile = in2.binning.tile_counts, in2.origins, in2.tile_shape
    packed, color = in2.rows.contiguous(), in2.color
    rows_g = in1.rows[:, :8].transpose(1, 2).contiguous()
    del in1
    th, tw = tile
    ny, nx = in2.binning.num_tiles
    ones = torch.ones(3, device=device)

    def cotangents(accum, tfinal):
        la, lt = accum.clone().requires_grad_(True), tfinal.clone().requires_grad_(True)
        full = torch.cat([la[..., 0:3] + lt * ones, la[..., 3:4], 1.0 - lt], dim=-1)
        image = (full.reshape(ny, nx, th, tw, 5).permute(0, 2, 1, 3, 4)
                 .reshape(ny * th, nx * tw, 5)[:H, :W])
        loss = ((image[..., 0:3] - frame.img.permute(1, 2, 0)).abs().mean()
                + image[..., 4].mean() + image[..., 3].mean())
        return tuple(x.contiguous() for x in torch.autograd.grad(loss, (la, lt)))

    # the row-major boundary with global rows and origins: the entry point of
    # kernels 5 and 6, forward and backward, counted as a path of its own
    reset_launches()
    for o in (None, origins):
        q = (packed if o is None else rows_g).clone().requires_grad_(True)
        c = color.clone().requires_grad_(True)
        acc, tf = api._CompositeRowMajor.apply(q, c, counts, o, tile, 1)
        torch.autograd.grad(acc.sum() + tf.sum(), (q, c))
    sync()
    res["launches"]["rowmajor_boundary"] = read_launches()
    expect_launches("rowmajor_boundary", {"composite_tiles_fwd": 2, "composite_tiles_bwd": 2})
    del q, c, acc, tf

    stat = {}
    live_rows = int(torch.clamp(counts.long(), max=packed.shape[1]).sum())
    T, P = packed.shape[0], th * tw
    cases = (("composite_tiles_fwd_v2", "composite_tiles_bwd_v2", packed, None),
             ("composite_tiles_fwd", "composite_tiles_bwd", rows_g, origins))
    for fwd_name, bwd_name, quad, o in cases:
        fwd, bwd = getattr(kn, fwd_name), getattr(kn, bwd_name)
        extra = () if fwd_name.endswith("v2") else (o,)
        got_f = fwd(quad, color, counts, tile, *extra)
        sync()
        t0 = time.perf_counter()
        accum_p, tfinal_p, visits = kn.composite_rm_plain_with_visits(quad, color, counts, tile, o)
        sync()
        plain_f_ms = 1e3 * (time.perf_counter() - t0)
        e_f = rm_max_err(got_f, (accum_p, tfinal_p))
        check(f"{fwd_name} vs plain (scene+human windows)", within(e_f, TOL), f"{e_f}")
        cot = cotangents(*got_f)
        got_b = bwd(quad, color, counts, *cot, *got_f, tile, *extra)
        sync()
        t0 = time.perf_counter()
        dq_p, dc_p, bstats = kn.composite_rm_bwd_plain_with_stats(quad, color, counts, *cot,
                                                                   accum_p, tfinal_p, tile, o)
        sync()
        plain_b_ms = 1e3 * (time.perf_counter() - t0)
        e_b = rm_grad_rows(got_b, (dq_p, dc_p))
        res["ok"] &= e_b["ok"]
        log_grad_rows("train", f"{bwd_name} (scene+human windows)", e_b)
        past = torch.arange(quad.shape[1], device=device)[None, :] >= counts[:, None]
        check(f"{bwd_name} dead slots", not bool(got_b[0][past].any() or got_b[1][past].any()),
              "exact zeros at and past each tile's count")
        n_visits = int(visits.sum())
        f_ops = n_visits * OPS_PER_VISIT / PEAK_F32_FLOPS
        f_bytes = (live_rows * RM_BYTES_PER_ROW + T * P * BYTES_PER_PIXEL) / PEAK_BYTES
        b_ops = (bstats.visits * OPS_PER_VISIT + bstats.hits * OPS_PER_HIT) / PEAK_F32_FLOPS
        b_bytes = (2 * live_rows * RM_BYTES_PER_ROW + T * P * BWD_BYTES_PER_PIXEL) / PEAK_BYTES
        stat[fwd_name] = {"bound_ms": 1e3 * max(f_ops, f_bytes),
                          "bound_by": "operations" if f_ops >= f_bytes else "bytes",
                          "plain_ms": plain_f_ms, "max_abs_err": max(e_f.values())}
        stat[bwd_name] = {"bound_ms": 1e3 * max(b_ops, b_bytes),
                          "bound_by": "operations" if b_ops >= b_bytes else "bytes",
                          "plain_ms": plain_b_ms, "max_abs_err": e_b["max_abs_err"],
                          "max_row_rel_err": e_b["max_row_rel_err"]}
        log(f"[train] {fwd_name}/{bwd_name}: {live_rows} live rows, {n_visits} visits, backward "
            f"{bstats.visits} visits and {bstats.hits} contributing; bounds "
            f"{stat[fwd_name]['bound_ms']:.6f} ms ({stat[fwd_name]['bound_by']}; bytes "
            f"{1e3 * f_bytes:.6f}) / {stat[bwd_name]['bound_ms']:.6f} ms "
            f"({stat[bwd_name]['bound_by']}; bytes {1e3 * b_bytes:.6f})")
        if on_card:
            ff = lambda: fwd(quad, color, counts, tile, *extra)
            fb = lambda: bwd(quad, color, counts, *cot, *got_f, tile, *extra)
            cuda_ms(ff, 2), cuda_ms(fb, 2)  # warm-up
            stat[fwd_name]["ms"], stat[bwd_name]["ms"] = cuda_ms(ff, 10), cuda_ms(fb, 10)
            for k in (fwd_name, bwd_name):
                log(f"[train] {k}: {stat[k]['ms']:.4f} ms, plain {stat[k]['plain_ms']:.2f} ms, "
                    f"bound {stat[k]['bound_ms']:.6f} ms ({stat[k]['bound_by']})")
        del got_f, got_b, accum_p, tfinal_p, dq_p, dc_p, cot
    del both, packed, color, rows_g, in2, counts, origins

    # ---- 4. densify/prune at an iteration where it fires, opacity reset,
    # capacity growth
    def adjust(st, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return tl.maybe_adjust_gaussians(st, cfg.densify_start_itr + cfg.densify_interval, cfg,
                                         generator=g)

    aux = state.scene_aux
    grad = torch.where(aux.track_cnt > 0, aux.xyz_grad_accum / aux.track_cnt.clamp(min=1), 0.0)
    n_hot = int((aux.live & (grad >= cfg.densify_grad_thr)).sum())
    log(f"[train] tracked statistics: {n_hot} live rows at or above densify_grad_thr="
        f"{cfg.densify_grad_thr} (largest mean gradient {float(grad.max()):.3e})")
    if n_hot == 0:
        log("[train] the threshold selects nothing at these random weights: seeding the "
            "statistics of every tenth live row above it")
        pick = aux.live & (torch.arange(aux.live.shape[0], device=device) % 10 == 0)
        state = state._replace(scene_aux=dataclasses.replace(
            aux, xyz_grad_accum=torch.where(pick, 1.0, aux.xyz_grad_accum),
            track_cnt=torch.where(pick, 1.0, aux.track_cnt)))
    # the same pass on a copy with the same seed gives the reset mask
    twin = copy.deepcopy(state)
    mask = sc.densify_and_prune(
        sc.SceneState(twin.trainables.scene, twin.scene_aux), cfg, False,
        generator=torch.Generator(device=device).manual_seed(11)).reset_mask
    del twin
    live_before = state.scene_aux.live.clone()
    had = float(state.opt_state.mu["scene.mean"][mask].abs().sum())
    state, stats = adjust(state, 11)
    stats = {k: int(v) for k, v in stats.items()}
    log(f"[train] densify at itr {cfg.densify_start_itr + cfg.densify_interval}: {stats}")
    granted = stats["n_cloned"] + 2 * stats["n_split"] - stats["n_dropped"]
    kept = int((live_before & ~mask).sum())
    zeroed = all(not bool(m[k][mask].any()) for m in (state.opt_state.mu, state.opt_state.nu)
                 for k in m if k.startswith("scene."))
    check("densify", stats["n_cloned"] + stats["n_split"] > 0
          and stats["n_live"] == int(state.scene_aux.live.sum()) == kept + granted and zeroed
          and (had > 0 or stats["n_split"] + stats["n_pruned"] == 0)
          and not bool(state.scene_aux.track_cnt.any()),
          f"live {int(live_before.sum())} -> {stats['n_live']} = {kept} untouched + {granted} "
          f"granted; both moments of the {int(mask.sum())} reset rows zero (|mu| there was "
          f"{had:.3e}); statistics restarted")
    state, losses = tl.train_step(state, bundle, frame, opt, cfg, is_warmup=False,
                                  settings=settings, bg=bg)
    check("step after densify", finite(state, losses), f"total {float(losses['total']):.5f}")

    state = tl.opacity_reset_step(state)
    op = torch.sigmoid(state.trainables.scene.opacity.detach())[state.scene_aux.live]
    check("opacity reset", bool((op <= 0.0101).all())
          and not bool(state.opt_state.mu["scene.opacity"].any())
          and not bool(state.opt_state.nu["scene.opacity"].any())
          and bool(state.opt_state.mu["scene.mean"].any()),
          f"largest live opacity {float(op.max()):.5f}, opacity moments zero")
    count = state.opt_state.count
    state = tl.grow_scene_capacity(state, grow_to)
    C = state.trainables.scene.mean.shape[0]
    check("capacity growth", C == grow_to == state.scene_aux.live.shape[0]
          and state.opt_state.mu["scene.feature_rest"].shape[0] == grow_to
          and state.opt_state.count == count and int(state.scene_aux.live.sum()) == stats["n_live"],
          f"scene rows {C}, moments padded, step count {count} kept")
    state, losses = tl.train_step(state, bundle, frame, opt, cfg, is_warmup=False,
                                  settings=settings, bg=bg)
    check("step after growth", finite(state, losses)
          and not bool(state.opt_state.mu["scene.mean"][~state.scene_aux.live].any()),
          f"total {float(losses['total']):.5f}; dead rows got no gradient")

    # ---- 5. a checkpoint written and read back on the device
    path = save_checkpoint(model_dir, state, epoch=99)
    loaded, epoch = load_checkpoint(latest_checkpoint(model_dir), cfg, device=device)
    a, b = convert.train_state_to_numpy(state), convert.train_state_to_numpy(loaded)
    same = epoch == 99 and all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                               and (a[k] == b[k]).all() for k in a)
    keep = copy.deepcopy(state)
    _, l_a = tl.train_step(keep, bundle, frame, opt, cfg, is_warmup=False, settings=settings,
                           bg=bg)
    _, l_b = tl.train_step(loaded, bundle, frame, opt, cfg, is_warmup=False, settings=settings,
                           bg=bg)
    rel = abs(float(l_a["total"]) - float(l_b["total"])) / abs(float(l_a["total"]))
    check("checkpoint", same and rel <= 1e-5 and loaded.trainables.scene.mean.device.type == device,
          f"{len(a)} leaves bit for bit ({os.path.getsize(path) / 2**20:.1f} MiB), next step's "
          f"total {float(l_b['total']):.6f} vs {float(l_a['total']):.6f} (relative {rel:.2e}, "
          f"limit 1e-5)")
    del keep, loaded, a, b
    for f in os.listdir(model_dir):
        os.remove(os.path.join(model_dir, f))
    os.rmdir(model_dir)

    res["kernel_stats"] = stat
    return res


# --------------------------------------------------------------------------
# phase 7: the probe tools at their defaults (kernels 9-11)
# --------------------------------------------------------------------------


def rm_resources() -> dict:
    """{(fwd|bwd, variant id): (registers, shared bytes)} of the LOCALIZE
    instantiations of csrc/composite_rm.cu's two kernel templates."""
    found = ptxas_resources("composite_rm", r"composite_rm_(fwd|bwd)_kernelILb1ELi(\d+)E")
    return {(d, int(v)): r[:2] for (d, v), r in found.items()}


def windows_on_binning(screen, img, tile_shape, K, binning, max_pairs):
    """The window kernel on a real binning's sorted pairs against the
    binning's own windows (``binning._windows``), integer for integer:
    (equal, detail)."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    n = screen.mean2d.shape[0]
    _, _, rank_sorted, starts, _, _, _, _ = bnm._compact_sorted_pairs(
        screen.mean2d, screen.radius, screen.depth, screen.in_frustum, img, *tile_shape,
        max_pairs, screen.extent)
    got = kn.tile_windows(starts.int(), rank_sorted.int(), K, n)
    same = torch.equal(got, binning.tile_indices)
    return same, (f"(T, K) = {tuple(got.shape)} from {int(starts[-1])} sorted pairs equals the "
                  f"binning's windows: {same}")


def phase_probes(device, n=100_000, check_tiles=16, iters=10, win_inputs=None) -> dict:
    """``tools.kvariants`` and ``tools.win_probe`` as a user runs them, at
    their defaults: every variant against its plain version on the first
    ``check_tiles`` tiles (forward 1e-5 of each output's max, backward each
    row against its own max, GRAD_TOL), base bit-equal to kernels 5 and 6
    (the backward to atomics order, 1e-6 of each row), every exact variant
    within those limits of base; then, counters at 0 just before and read
    just after, the tools' timing runs on the whole scene; the window kernel
    integer for integer against the binning's gather, at the tool's seeded
    inputs and on the scene's own binning; each variant's bound from its own
    plain version's visits on the whole scene. Rows 9 and 10 of the kernels
    line take the mean launch of the variants other than base, which is
    kernel 5 / 6 itself and counts there. ``win_inputs`` (starts, rank_pad, K, n)
    replaces the tool's seeded window inputs (a rehearsal at a small size)."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
    from exavatar_release_tpu_torch.tools import kvariants as kv
    from exavatar_release_tpu_torch.tools import win_probe as wp

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[probes] {name}: {detail} {'ok' if cond else 'FAIL'}")

    t0 = time.perf_counter()
    s = kv.build_scene(n, device=device)
    T, K = s["quad"].shape[:2]
    bn = s["binning"]
    live_rows = int(torch.clamp(s["counts"].long(), max=K).sum())
    log(f"[probes] scene: {n} Gaussians, {T} tiles of {s['tile_shape']}, K={K}, {live_rows} live "
        f"rows, {int(bn.n_truncated)} pairs past K, built in {time.perf_counter() - t0:.1f} s")

    # ---- every variant against its plain version on the first tiles
    sub = kv.sub_scene(s, check_tiles)
    P = s["tile_shape"][0] * s["tile_shape"][1]
    g = torch.Generator(device="cpu").manual_seed(7)
    cot = (torch.randn(check_tiles, P, 4, generator=g).to(device),
           torch.randn(check_tiles, P, 1, generator=g).to(device))
    f5 = kn.composite_tiles_fwd(sub["quad"], sub["color"], sub["counts"], sub["tile_shape"],
                                sub["origins"])
    b6 = kn.composite_tiles_bwd(sub["quad"], sub["color"], sub["counts"], *cot, *f5,
                                sub["tile_shape"], sub["origins"])

    def fwd_err(got, want):
        return max(own_scale_err(got[0], want[0]), own_scale_err(got[1], want[1]))

    errs = {}
    base_f = kv.fwd("base", sub)
    sync()
    check("fwd/base == composite_tiles_fwd with origins", torch.equal(base_f[0], f5[0])
          and torch.equal(base_f[1], f5[1]), "bit for bit")
    for v in kn.FWD_VARIANTS:
        got = kv.fwd(v, sub)
        want = kv.fwd(v, sub, plain=True)
        sync()
        e = fwd_err(got, want)
        errs[f"fwd/{v}"] = max(float((got[0] - want[0]).abs().max()),
                               float((got[1] - want[1]).abs().max()))
        line = f"{e:.3e} of each output's max (limit 1e-5)"
        ok = e <= 1e-5
        if v in kn.EXACT_VARIANTS:
            eb = fwd_err(got, base_f)
            ok &= eb <= 1e-5
            line += f"; vs base {eb:.3e}"
        check(f"fwd/{v} vs plain", ok, line)
    base_b = kv.bwd("base", sub, cot, f5)
    r = rm_grad_rows(base_b, b6)
    check("bwd/base == composite_tiles_bwd with origins", r["max_row_rel_err"] <= 1e-6,
          f"worst row {r['max_row_rel_err']:.3e} of its own max (atomics order; limit 1e-6)")
    for v in kn.BWD_VARIANTS:
        got = kv.bwd(v, sub, cot, f5)
        want = kv.bwd(v, sub, cot, f5, plain=True)
        sync()
        errs[f"bwd/{v}"] = max(float((got[0] - want[0]).abs().max()),
                               float((got[1] - want[1]).abs().max()))
        if v == "nograd":
            check("bwd/nograd", not bool(got[0].any() or got[1].any()), "exact zeros")
            continue
        r = rm_grad_rows(got, want)
        ok, line = r["ok"], (f"worst row {r['max_row_rel_err']:.3e} of its own max "
                             f"(limit {GRAD_TOL})")
        if v in kn.EXACT_VARIANTS:
            rb = rm_grad_rows(got, base_b)
            ok &= rb["ok"]
            line += f"; vs base {rb['max_row_rel_err']:.3e}"
        check(f"bwd/{v} vs plain", ok, line)
    del sub, cot, f5, b6, base_f, base_b

    # ---- the tools' runs: the path the counters read
    if win_inputs is None:
        starts, rank_pad = wp.seeded_inputs(device)
        wK, wn = wp.K, wp.N
    else:
        starts, rank_pad, wK, wn = win_inputs
    reset_launches()
    probe = kv.run_probes(s, iters, log=lambda m: log(f"[probes] {m}"))
    win = wp.run_probe(starts, rank_pad, wK, wn, iters, log=lambda m: log(f"[probes] {m}"))
    sync()
    res["launches"] = read_launches()
    log(f"[probes] launches of the tools' runs: {res['launches']}")
    for k in PROBE_KERNELS:
        check(f"{k} launched", not on_card or res["launches"][k] > 0,
              f"{res['launches'][k]} launches")
    check("win_probe parity at its defaults", win["parity"], "integer for integer")

    # ---- the window kernel on the scene's own binning
    ok, detail = windows_on_binning(s["screen"], kv.IMG, s["tile_shape"], K, bn,
                                    bnm.default_max_pairs(n, s["tile_shape"][0]))
    check("tile_windows on the scene's binning", ok, detail)

    # ---- each variant's work (its plain version's visit count, for the
    # attribution: a stub can change how early pixels end), the bounds from
    # base's, and the plain versions' times, on the whole scene
    args = (s["quad"], s["color"], s["counts"])
    ref_f = kn.composite_tiles_fwd(*args, s["tile_shape"], s["origins"])
    ones = (torch.ones_like(ref_f[0]), torch.ones_like(ref_f[1]))
    plain_ms, work, hits = {}, {}, {}
    for v in kn.FWD_VARIANTS:
        t0 = time.perf_counter()
        _, _, vis = kn.composite_tiles_fwd_variant_plain_with_visits(v, *args, s["tile_shape"],
                                                                     s["origins"])
        sync()
        plain_ms[f"fwd/{v}"] = 1e3 * (time.perf_counter() - t0)
        work[f"fwd/{v}"] = int(vis.sum())
    for v in kn.BWD_VARIANTS:
        t0 = time.perf_counter()
        _, _, st = kn.composite_tiles_bwd_variant_plain_with_stats(
            v, *args, *ones, *ref_f, s["tile_shape"], s["origins"])
        sync()
        plain_ms[f"bwd/{v}"] = 1e3 * (time.perf_counter() - t0)
        work[f"bwd/{v}"], hits[f"bwd/{v}"] = st.visits, st.hits
    f_bytes = (live_rows * RM_BYTES_PER_ROW + T * P * BYTES_PER_PIXEL) / PEAK_BYTES
    b_bytes = (2 * live_rows * RM_BYTES_PER_ROW + T * P * BWD_BYTES_PER_PIXEL) / PEAK_BYTES

    def bound(key):
        """(ms, bound_by) of one variant from its own plain version's work:
        nograd's replay skips the ten adds of the reduction over pixels."""
        ops = work[key] * OPS_PER_VISIT
        if key.startswith("bwd/"):
            ops += hits[key] * (OPS_PER_HIT - (10 if key == "bwd/nograd" else 0))
        ops_s, bytes_s = ops / PEAK_F32_FLOPS, f_bytes if key.startswith("fwd/") else b_bytes
        return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"

    wT = starts.shape[0] - 1
    live_w = int(torch.clamp(starts[1:].long() - starts[:-1].long(), max=wK).sum())
    w_bytes = 4 * (live_w + wT * wK + wT + 1) / PEAK_BYTES
    fw, bw = probe["fwd"], probe["bwd"]
    regs = rm_resources()
    res["kernel_stats"] = {}
    mean = lambda xs: sum(xs) / len(xs)
    for d, times, name in (("fwd", fw, "composite_tiles_fwd_variant"),
                           ("bwd", bw, "composite_tiles_bwd_variant")):
        # the row's own launches: base is kernel 5 / 6 and counts there
        own = [v for v in times if v != "base"]
        bounds = {v: bound(f"{d}/{v}") for v in times}
        res["kernel_stats"][name] = {
            "ms": mean([times[v] for v in own]),
            "ms_of": f"mean per launch over the {len(own)} variants other than base",
            "plain_ms": mean([plain_ms[f"{d}/{v}"] for v in own]),
            "bound_ms": mean([bounds[v][0] for v in own]),
            "bound_by": bounds[own[0]][1],
            "max_abs_err": max(errs[f"{d}/{v}"] for v in own),
            "variants_ms": times, "variants_bound_ms": {v: b[0] for v, b in bounds.items()},
            "variants_registers": {v: regs.get((d, kn.VARIANT_IDS[v])) for v in times}}
    res["kernel_stats"]["tile_windows"] = {
        "ms": win["ms"]["kernel"], "plain_ms": win["ms"]["gather"],
        "library_ms": win["ms"]["gather"], "bound_ms": 1e3 * w_bytes, "bound_by": "bytes",
        "max_abs_err": 0.0 if win["parity"] else math.inf}
    log(f"[probes] bytes bounds: forward {1e3 * f_bytes:.6f} ms, backward {1e3 * b_bytes:.6f} "
        f"ms; windows {1e3 * w_bytes:.6f} ms ({live_w} live entries of {wT} x {wK})")
    for d, times in (("fwd", fw), ("bwd", bw)):
        b_ms, b_work = times["base"], work[f"{d}/base"]
        for k, v in times.items():
            w = work[f"{d}/{k}"]
            extra = f", {hits[f'{d}/{k}']} contributing" if d == "bwd" else ""
            log(f"[probes] {d}/{k}: {v:.4f} ms ({v - b_ms:+.4f} = {100 * (v / b_ms - 1):+.1f}% "
                f"of base), {w} visits{extra} ({w / b_work:.3f} x base), {1e9 * v / w:.4f} ps "
                f"per visit ({100 * ((v / w) / (b_ms / b_work) - 1):+.1f}% of base's); bound "
                f"{bound(f'{d}/{k}')[0]:.6f} ms; registers, shared bytes "
                f"{regs.get((d, kn.VARIANT_IDS[k]))}; plain {plain_ms[f'{d}/{k}']:.1f} ms")
    res["kernel_stats"]["composite_tiles_fwd_variant"]["variants_visits"] = {
        k: work[f"fwd/{k}"] for k in fw}
    res["kernel_stats"]["composite_tiles_bwd_variant"]["variants_visits"] = {
        k: work[f"bwd/{k}"] for k in bw}
    return res


# --------------------------------------------------------------------------
# phase 8: the avatar CLIs on a subject directory
# --------------------------------------------------------------------------


def write_subject(root: str, img=(1080, 1920), n_frames: int = 3, n_points: int = 5000,
                  focal: float = 1200.0, seed: int = 0) -> None:
    """A seeded subject directory in the reference layout, everything
    ``data.subject.load_subject`` reads, written without cv2: COLMAP text
    (one PINHOLE camera, near-identity extrinsics per frame, a point cloud
    behind the subject), RGB frames and masks as PNG (utils/png.py),
    whole-body keypoints inside the mask, SMPL-X parameters with the subject
    2.5 m in front of the camera, identity tables and the train split."""
    import json

    import numpy as np

    from exavatar_release_tpu_torch.utils.png import write_png

    H, W = img
    rng = np.random.default_rng(seed)
    for d in ("sparse", "images", "masks", "keypoints_whole_body", "smplx_optimized/smplx_params"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "sparse", "cameras.txt"), "w") as f:
        f.write(f"# cameras\n1 PINHOLE {W} {H} {focal} {focal} {W / 2} {H / 2}\n")
    with open(os.path.join(root, "sparse", "images.txt"), "w") as f:
        f.write("# images\n")
        for i in range(n_frames):
            q = np.concatenate([[1.0], rng.normal(0, 0.02, 3)])
            q /= np.linalg.norm(q)
            t = rng.normal(0, 0.05, 3)
            f.write(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} 1 {i}.png\n0 0 -1\n")
    with open(os.path.join(root, "sparse", "points3D.txt"), "w") as f:
        f.write("# points\n")
        xyz = np.stack([rng.uniform(-4, 4, n_points), rng.uniform(-2.5, 2.5, n_points),
                        rng.uniform(4, 12, n_points)], 1)
        rgb = rng.integers(0, 256, (n_points, 3))
        f.writelines(f"{i} {x} {y} {z} {r} {g} {b} 0.1\n"
                     for i, ((x, y, z), (r, g, b)) in enumerate(zip(xyz, rgb)))
    x0, x1, y0, y1 = int(0.4 * W), int(0.6 * W), int(0.12 * H), int(0.95 * H)
    for i in range(n_frames):
        coarse = rng.integers(0, 256, (H // 8 + 1, W // 8 + 1, 3), np.uint8)
        write_png(os.path.join(root, "images", f"{i}.png"),
                  np.kron(coarse, np.ones((8, 8, 1), np.uint8))[:H, :W])
        mask = np.zeros((H, W), np.uint8)
        mask[y0:y1, x0:x1] = 255
        write_png(os.path.join(root, "masks", f"{i}.png"), mask)
        kpt = np.concatenate([rng.uniform(x0, x1, (135, 1)), rng.uniform(y0, y1, (135, 1)),
                              rng.uniform(0.6, 1.0, (135, 1))], 1)
        with open(os.path.join(root, "keypoints_whole_body", f"{i}.json"), "w") as f:
            json.dump(kpt.tolist(), f)
        params = {
            "root_pose": [math.pi, 0.0, 0.0], "body_pose": rng.normal(0, 0.1, (21, 3)).tolist(),
            "jaw_pose": rng.normal(0, 0.05, 3).tolist(), "leye_pose": [0, 0, 0],
            "reye_pose": [0, 0, 0], "lhand_pose": rng.normal(0, 0.1, (15, 3)).tolist(),
            "rhand_pose": rng.normal(0, 0.1, (15, 3)).tolist(),
            "expr": rng.normal(0, 0.3, 8).tolist(), "trans": [0.0, 0.1, 2.5],
        }
        with open(os.path.join(root, "smplx_optimized", "smplx_params", f"{i}.json"), "w") as f:
            json.dump(params, f)
    for name, shape in (("shape_param.json", (16,)), ("face_offset.json", (10, 3)),
                        ("joint_offset.json", (55, 3)), ("locator_offset.json", (55, 3))):
        with open(os.path.join(root, "smplx_optimized", name), "w") as f:
            json.dump(np.zeros(shape).tolist(), f)
    with open(os.path.join(root, "train_split.txt"), "w") as f:
        f.write("".join(f"{i}.png\n" for i in range(n_frames)))


def phase_apps(device, img=(1080, 1920), n_frames=3, n_points=5000, triplane=(32, 128),
               num_views=4, extra=()) -> dict:
    """The four CLIs as a user runs them, on a subject directory written by
    ``write_subject``: ``apps.train.main`` (native frame loader, 2 epochs of
    ``n_frames`` steps, a snapshot each), ``apps.test.main`` and
    ``apps.evaluate.main`` on the last snapshot, ``apps.animate.main`` with a
    turntable camera over ``num_views`` motion files. Counters at 0 just
    before the train run and read just after the animate run. ``extra``:
    more CLI options for every call (``--scene_capacity`` for a rehearsal at
    a small size)."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from exavatar_release_tpu_torch.apps import animate, evaluate, test, train
    from exavatar_release_tpu_torch.avatar.config import AvatarConfig
    from exavatar_release_tpu_torch.data.subject import read_rgb
    from exavatar_release_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[apps] {name}: {detail} {'ok' if cond else 'FAIL'}")

    work = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    root, out = os.path.join(work, "subject"), os.path.join(work, "out")
    t0 = time.perf_counter()
    write_subject(root, img, n_frames, n_points)
    H, W = img
    log(f"[apps] subject {W}x{H}, {n_frames} frames, {n_points} points written in "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--subject_root", root, "--device", device, "--triplane_ch", str(triplane[0]),
              "--triplane_res", str(triplane[1]), *extra]
    reset_launches()
    t0 = time.perf_counter()
    run = train.main(common + ["--allow_random_lpips", "--loader", "native", "--epochs", "2",
                               "--repeat", "1", "--out_dir", out])
    res["train_s"] = time.perf_counter() - t0
    hist = run.history
    res["step_s"] = [h["step_s"] for h in hist]
    res["read_s"] = [h["read_s"] for h in hist]
    log(f"[apps] train: {len(hist)} steps in {res['train_s']:.2f} s; per step, step s "
        f"{[round(x, 4) for x in res['step_s']]}, read s {[round(x, 4) for x in res['read_s']]}; "
        f"totals {[round(h['total'], 4) for h in hist]}; settings at the end {run.settings}")
    model_dir = os.path.join(out, "model_dump")
    snaps = sorted(f for f in os.listdir(model_dir) if f.endswith(".npz"))
    ckpt = latest_checkpoint(model_dir)
    cfg = AvatarConfig(triplane_ch=triplane[0], triplane_res=triplane[1])
    loaded = [load_checkpoint(os.path.join(model_dir, f), cfg, device) for f in snaps]
    finite = all(np.isfinite(h["total"]) for h in hist)
    check("train", len(hist) == 2 * n_frames and snaps == ["snapshot_0.npz", "snapshot_1.npz"]
          and [e for _, e in loaded] == [0, 1] and loaded[-1][0].itr == 2 * n_frames and finite,
          f"{len(hist)} steps, snapshots {snaps} load (epochs {[e for _, e in loaded]}), "
          f"losses finite")
    del loaded

    result_dir = os.path.join(out, "result")
    t0 = time.perf_counter()
    test.main(common + ["--ckpt", ckpt, "--out_dir", result_dir])
    res["test_s"] = time.perf_counter() - t0
    blank = []
    for i in range(n_frames):
        im = read_rgb(os.path.join(result_dir, f"{i}_scene_human_img_refined_composed.png"))
        if float(im.std()) == 0.0:
            blank.append(i)
    n_png = len([f for f in os.listdir(result_dir) if f.endswith(".png")])
    check("test", n_png == 9 * n_frames and not blank,
          f"{n_png} PNGs in {res['test_s']:.2f} s, blank composed frames {blank}")

    t0 = time.perf_counter()
    metrics = evaluate.main(common + ["--ckpt", ckpt, "--out_json",
                                      os.path.join(out, "metrics.json")])
    res["evaluate_s"] = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.json")) as f:
        written = json.load(f)
    check("evaluate", written == metrics and all(math.isfinite(v) for v in metrics.values()),
          f"{metrics} in {res['evaluate_s']:.2f} s")

    motion = os.path.join(work, "motion")
    os.makedirs(motion)
    for v in range(num_views):
        shutil.copy(os.path.join(root, "smplx_optimized", "smplx_params", f"{v % n_frames}.json"),
                    os.path.join(motion, f"{v:04d}.json"))
    t0 = time.perf_counter()
    frames = animate.main(common + ["--ckpt", ckpt, "--motion_dir", motion, "--view_rot",
                                    "--num_views", str(num_views), "--out_dir",
                                    os.path.join(out, "animate")])
    res["animate_s"] = time.perf_counter() - t0
    check("animate", len(frames) == num_views and all(os.path.exists(p) for p in frames),
          f"{len(frames)} frames in {res['animate_s']:.2f} s")
    if device == "cuda":
        torch.cuda.synchronize()
    res["launches"] = read_launches()
    log(f"[apps] launches of train, test, evaluate and animate: {res['launches']}")
    loaded_mods = sorted({m.split(".")[0] for m in sys.modules} & {"cv2", "jax", "jaxlib"})
    check("no cv2 and no jax loaded", not loaded_mods, f"{loaded_mods or 'none'} in sys.modules")
    shutil.rmtree(work)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from exavatar_release_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in cuda_build.LIBRARIES:
        for line in cuda_build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {lib}: {line.strip()}")
    for k, (regs, smem, st, ld) in pairs_resources().items():
        log(f"[build] {k}: {regs} registers, {smem} bytes shared memory, spills {st} B stored / "
            f"{ld} B loaded")

    # ``--phases a,b`` runs a part (random, goldens, animate, frame, train,
    # probes, apps) and
    # prints no result line: the contract needs every phase
    only = None
    if "--phases" in sys.argv[1:]:
        only = set(sys.argv[sys.argv.index("--phases") + 1].split(","))
    want = lambda name: only is None or name in only
    ok = True
    rnd = phase_kernels_random("cuda") if want("random") else None
    ok &= rnd is None or rnd["ok"]
    ok &= not want("goldens") or phase_goldens("cuda")
    anim = phase_animate("cuda") if want("animate") else None
    ok &= anim is None or anim["ok"]
    frm = phase_frame("cuda") if want("frame") else None
    ok &= frm is None or frm["ok"]
    trn = phase_train("cuda") if want("train") else None
    ok &= trn is None or trn["ok"]
    prb = phase_probes("cuda") if want("probes") else None
    ok &= prb is None or prb["ok"]
    app = phase_apps("cuda") if want("apps") else None
    ok &= app is None or app["ok"]
    if only is not None:
        log(f"chip_smoke: phases {sorted(only)} {'passed' if ok else 'FAILED'}; a partial run "
            f"prints no result line")
        return 0 if ok else 1

    kernels = []
    pairs = pairs_resources()
    for name in ALL_KERNELS:
        fwd = name in FWD_KERNELS + RM_FWD_KERNELS
        # channel-major and pair-major forward kernels: measured on the animate
        # frame's windows, their backward kernels on the train-mode frame's
        # scene+human render; the row-major kernels on the trainer's; the
        # probe kernels at the probe tools' defaults
        if name in PROBE_KERNELS:
            st = prb["kernel_stats"][name]
        elif name in RM_FWD_KERNELS + RM_BWD_KERNELS:
            st = trn["kernel_stats"][name]
        else:
            st = (anim if fwd else frm)["kernel_stats"][name]
        by_path = {"animate": anim["launches"][name],
                   **{f"frame_{k}": v[name] for k, v in frm["launches"].items()},
                   **{k: v[name] for k, v in trn["launches"].items()},
                   "probes": prb["launches"][name], "apps": app["launches"][name]}
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": st["max_abs_err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            # no single PyTorch call composites Gaussians or differentiates
            # that; the windows' is the binning's own gather
            "library_ms": st.get("library_ms"),
        }
        if name in PROBE_KERNELS[:2]:
            for k in ("ms_of", "variants_ms", "variants_bound_ms", "variants_registers"):
                entry[k] = st[k]
        elif name not in PROBE_KERNELS:
            # the largest difference from the plain version, random windows included
            entry["max_abs_err"] = max(st["max_abs_err"], max(rnd[name].values()) if fwd
                                       else rnd[name]["max_abs_err"])
            if not fwd:  # the figure the backward kernels are held to (GRAD_TOL)
                entry["max_row_rel_err"] = max(st["max_row_rel_err"],
                                               rnd[name]["max_row_rel_err"])
        if name in pairs:  # kernels 7 and 8, from this run's build log
            entry["registers_smem_spills"] = pairs[name]
        kernels.append(entry)
    if not ok:
        print("chip_smoke: FAILED (see the lines above)", file=sys.stderr)
        return 1
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
