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
   against each other on the same scene; the forward kernels bit for bit.
   All eight run the pair bodies (one body each way); it prints, here, at
   the animate frame, at the train render and (3-6) at the trainer's
   windows, what their per-warp row cull leaves (``pair_cull_stats``, a
   model of it), and after the build their registers, shared memory,
   spills and stack frames;
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
   step's windows;
7. runs the probe tools (``phase_probes``): the stage probes against their
   plain versions and timed, and the window kernel (kernel 11) integer for
   integer against the binning's gather at the tool's inputs, on the probe
   scene's binning and on its edge cases, timed per launch on the device
   (``kernel_ab.windows_times``: a replayed CUDA graph, outputs cycled past
   the L2 and into one L2-resident output) beside the wrapper's host time and
   an empty kernel's launch floor, here and (``phase_animate``) at the
   animate frame's dense binning, where it is also timed inside the dense
   frames (``kernel_ab.windows_in_frame``);
8. runs the learning check (``phase_convergence``): the convergence demo
   through the kernels at the JAX package's two bars, +5 dB in 300 steps at
   48x64 and +8 dB in 1000 steps at 512x896;
9. runs the CLIs (``phase_apps``): train, test, evaluate and animate on a
   subject directory, the train CLI with ``--profile_dir`` past iteration 40
   (its trace must name the compositing kernels), and the four CLIs with
   ``--human_model_path`` on a directory in the released files' layout
   written from the synthetic arrays;
10. runs the preprocessing and fitting half (``phase_fit``; in a child
   process, ``chip_smoke.py --phases fit``, while the learning check runs:
   both are bound by the host and neither times a kernel):
   ``apps.preprocess.main`` from a ``video.mp4`` of 64 frames of 1920x1080 to
   ``bkg_point_cloud.txt`` on a subject written from posed bodies of that
   layout, with the keypoint, mask and depth networks injected (their files
   are not in the repository): the frames extracted, the detectors' drivers,
   ``apps.fit.main`` at its defaults (three epochs, cut to 260 / 40 / 40
   iterations) with its check renders, ``apps.unwrap.main``, the smoothing
   with its check video and the background cloud; checks every output
   against what the detectors were given and the cloud against the seeded
   background plane; then on one frame the depth alignment, the depth render
   and the cloud, ``umeyama`` and ``fitting_init``, one ``fit_step`` and
   ``unwrap_sequence`` on the card against the CPU; no compositing kernel
   runs there, as in JAX;
11. runs ``parallel/`` (``phase_parallel``): the train-mode frame's largest
   render split into four row bands on a local mesh of the card, tile-sharded
   and Gaussian-sharded (the ``all_to_all`` exchange as a transposition in
   the process), dense and pair-major, against the single-device render
   through the same kernels (outputs, input gradients, drops, the
   exchange's overflow, times); ``tools.multichip_scale`` at its defaults;
   then a ``torch.distributed`` world of one NCCL rank: the data x tile train
   step with and without ``gaussian_shard`` against ``train_step``, and the
   train CLI with ``--mesh data=1,tile=1 --gaussian_shard``. Kernels 1, 2, 7
   and 8 run the bands at their global row offsets.

Weights are random, drawn from seeded ``torch.Generator``s and then brought
into a trained avatar's range (Gaussian scales of ~6 mm, offsets of ~mm),
so tile occupancy and pair counts are those of a real avatar. TF32 is off
for matmuls and cuDNN. The whole run's time and each phase's are printed.
The last two lines are the ``kernels`` JSON and the contract line
``{"ok": true, "device": {...}}``; the card's name and power limit come on
the line before them.
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
T_START = time.perf_counter()

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
# kernels 1-8 run the pair bodies of composite.cu / composite_bwd.cu, and the
# stage probes (9, 10) the same bodies under their variants' hooks
KERNEL_SOURCE = {k: "exavatar_release_tpu_torch/csrc/composite.cu"
                 for k in FWD_KERNELS + RM_FWD_KERNELS + PROBE_KERNELS[:1]}
KERNEL_SOURCE.update({k: "exavatar_release_tpu_torch/csrc/composite_bwd.cu"
                      for k in BWD_KERNELS + RM_BWD_KERNELS + PROBE_KERNELS[1:2]})
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
# dp_tile_train_step at data 1, tile 1 against train_step, each gradient leaf
# (read from Adam's first moment) against its own largest value: both sum with
# atomics (index_add_, the backward kernels), and leaves that are small sums of
# cancelling terms amplify the order. On an H100 the worst leaf came out at
# 4.9e-5 to 3.1e-4 in six such comparisons, and train_step against itself at
# 4.6e-5 to 2.8e-4 in three; a wrong scale or a dropped band moves the leaves
# by tenths
DP_LEAF_TOL = 1e-3
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
    bytes, spill stores, spill loads, stack frame bytes)}, from ptxas's report
    in the build log of library ``lib`` (empty off the card)."""
    import re

    from exavatar_release_tpu_torch import cuda_build

    try:
        text = cuda_build.build_log(lib)
    except OSError:
        return {}
    out, cur, frame = {}, None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"entry function '\S*" + entry, line)
        if m:
            cur, frame = m.groups(), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and cur is not None:
            frame = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), int(m.group(2))) + frame
            cur = None
    return out


def pair_resources() -> dict:
    """{kernel: (registers, shared bytes, spill stores, spill loads, stack
    frame bytes)} of the kernels on the pair bodies, 1-8."""
    out = {}
    entry = r"(composite_(?:tiles_(?:fwd|bwd)(?:_cm|_v2)?|pairs_(?:fwd|bwd)_rg))_kernel"
    for lib in ("composite", "composite_bwd"):
        for (name,), r in ptxas_resources(lib, entry).items():
            out[name] = r
    return out


# composite_common.cuh's pair-major layout: kPairsR pixels a thread (a
# column), kLanesW x kLanesH lanes a warp, kWarps warps a block
PAIRS_R, LANES_W, LANES_H, PAIR_WARPS = 2, 8, 4, 8


class PairLayout(NamedTuple):
    """Where kernels 1-8 put each pixel of a th x tw tile
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
    """What the per-warp row cull of the pair bodies (kernels 1-8) leaves
    to do."""

    visits: int  # (pixel, row) visits of the plain version, trigger included
    visits_left: int  # of those, the ones whose row the pixel's warp does not cull
    warp_rows: int  # (warp, row) pairs the warps reach before their pixels end
    warp_rows_culled: int  # of those, the ones the warp culls


def pair_cull_stats(win, counts, origins, tile_shape, visits,
                    tiles_per_step: int = 32) -> CullStats:
    """The cull's effect on dense windows (T, 12, K) at the tiles' origins
    (or global conic rows (T, K, 8) transposed to (T, 8, K), kernels 5 and
    6), or with ``origins`` None on packed rows (T, K, 8) in tile-local
    coordinates (kernels 3 and 4), from the plain version's visits (T, P)
    per pixel (``kernels.composite_plain_with_visits``,
    ``composite_rm_plain_with_visits``): a pixel evaluates rows k <
    visits, and a warp reaches rows below the largest visits of its patch. A
    model of the kernels' schedule from ``kernels.row_pixel_box`` /
    ``packed_row_pixel_box``; the kernels count nothing themselves."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    packed = origins is None
    T = win.shape[0]
    K = win.shape[1] if packed else win.shape[2]
    if packed:
        origins = torch.zeros(T, 2, device=win.device)
    lay = pair_layout(tile_shape, win.device)
    npatch = lay.bounds.shape[0]
    n = torch.clamp(counts.long(), max=K)
    total = torch.zeros(4, dtype=torch.int64, device=win.device)
    for t0 in range(0, T, tiles_per_step):
        sl = slice(t0, min(T, t0 + tiles_per_step))
        box = (kn.packed_row_pixel_box(win[sl], tile_shape) if packed
               else kn.row_pixel_box(win[sl].permute(1, 0, 2)))
        miss = patch_misses(box, lay.bounds, origins[sl])
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


def pair_cull(tag: str, win, counts, origins, tile_shape, visits, what=None) -> None:
    """Logs what the per-warp row cull leaves of a scene (its dense windows,
    or packed rows with ``origins`` None, and the plain version's visits per
    pixel): for windows the dense kernels' cull and the pair-major kernels',
    which run the same body on the same rows; for packed rows kernels 3 and
    4's. ``what`` names another reading of the same windows."""
    st = pair_cull_stats(win, counts, origins, tile_shape, visits)
    what = what or ("kernel_v=2 packed cull (kernels 3 and 4, tile-local boxes)"
                    if origins is None
                    else "dense cull (= the pair-major cull: the same rows, the same body)")
    log(f"[{tag}] {what}: plain visits {st.visits}, left after the cull "
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
    # the forward kernels round every operation as the plain version does
    exact = torch.equal(out1, ref1) and torch.equal(out2, ref2)
    log(f"[kernels/random] forward kernels bit-equal to their plain versions: {exact}")
    res["ok"] = zeros_ok and exact and within(res["k1_vs_k2"], TOL)
    res["ok"] &= all(res[k]["ok"] for k in BWD_KERNELS)
    rm = kernels_random_rm(win, counts, origins, bg, out1, (th, tw))
    res["ok"] &= rm.pop("ok")
    res.update(rm)
    return res


def kernels_random_rm(win, counts, origins, bg, full_cm, tile_shape) -> dict:
    """The four row-major kernels on the same random windows, repacked:
    forward against the plain versions (TOL), kernel 5 with origins against
    the channel-major kernel's output (accum + tfinal bg against full),
    kernel 3 against kernel 5 without origins (which runs kernel 3's body)
    bit for bit; backward under
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
    *p3, visits3 = kn.composite_rm_plain_with_visits(packed, color, counts, tile_shape)
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
    log(f"[kernels/random] composite_tiles_fwd_v2 == its plain version, bit for bit: "
        f"{torch.equal(f3[0], p3[0]) and torch.equal(f3[1], p3[1])}")
    log(f"[kernels/random] composite_tiles_fwd with origins == its plain version, bit for bit: "
        f"{torch.equal(f5o[0], p5o[0]) and torch.equal(f5o[1], p5o[1])}")
    pair_cull("kernels/random", packed, counts, None, tile_shape, visits3)
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
    from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, api, rasterize
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    g_names = ("g_means3d", "g_scales", "g_quats", "g_opacities", "g_rgbs")

    def scene(d, dev):
        """The golden scene's Gaussians (differentiable), live mask, camera,
        image shape and background on device ``dev``."""
        H, W = int(d["H"]), int(d["W"])
        f = float(d["focal"])
        cam = Camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                     torch.tensor([f, f], device=dev),
                     torch.tensor([W / 2.0, H / 2.0], device=dev))
        args = [torch.from_numpy(d[k]).to(dev).requires_grad_(True)
                for k in ("means3d", "scales", "quats", "opacities", "rgbs")]
        return args, torch.from_numpy(d["live"]).to(dev), cam, (H, W), torch.from_numpy(
            d["bg"]).to(dev)

    def render_and_grads(d, s, dev):
        """Outputs and the input gradients of the goldens' fixed cotangent
        (tests/test_goldens.py:_loss), on device ``dev``."""
        args, live, cam, (H, W), bg = scene(d, dev)
        o = rasterize(*args, live, cam, (H, W), bg, s)
        wimg = (torch.arange(H * W * 3, dtype=torch.float32, device=dev).reshape(H, W, 3)
                % 7.0 + 1.0) / 7.0
        wd = (torch.arange(H * W, dtype=torch.float32, device=dev).reshape(H, W) % 5.0 + 1.0) / 5.0
        loss = ((o["img"] * wimg).sum() + (o["depth"] * wd).sum()
                + (o["mask"] * wd.T.reshape(H, W)).sum())
        return o, [g.cpu() for g in torch.autograd.grad(loss, args)]

    def forward_exact(d, s, dev) -> bool:
        """The forward kernel of the path against its plain version on the
        scene's own windows, bit for bit."""
        args, live, cam, img, bg = scene(d, dev)
        with torch.no_grad():
            inp = api.prepare(*args, live, cam, img, s)
            got = api.composite(inp, bg, s)
            b = inp.binning
            if s.pair_major:
                ny, nx = b.num_tiles
                want = kn.composite_pairs_fwd_rg_plain(inp.rows, b.tid, b.flags, bg, 0.0,
                                                       inp.tile_shape, ny * nx, inp.chunk, nx)
            else:
                want = kn.composite_tiles_fwd_cm_plain(inp.rows, b.tile_counts, inp.origins, bg,
                                                       inp.tile_shape)
        return torch.equal(got, want)

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
            exact = forward_exact(d, s, device)
            good &= g_golden <= g_tol and g_plain <= 1e-4 and exact
            ok &= good
            log(f"[goldens] {os.path.basename(p)} pair_major={pm} max abs diff {err}; input "
                f"gradients, max scaled diff: vs golden {g_golden:.3e} (limit {g_tol}), vs the "
                f"plain backward on the CPU {g_plain:.3e} (limit 0.0001); forward kernel "
                f"bit-equal to its plain version: {exact} {'ok' if good else 'FAIL'}")
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
        check("composite_tiles_fwd_cm vs plain (frame 0)", torch.equal(out1, ref1),
              f"{err1}, bit for bit")
        check("composite_pairs_fwd_rg vs plain (frame 0)", torch.equal(out2, ref2),
              f"{err2}, bit for bit")
        # the window kernel (kernel 11) on this frame's sorted pairs
        ok_w, detail, w_in = windows_on_binning(ind.screen, (H, W), ind.tile_shape, dense_k, b,
                                                dense.pairs_per_gaussian * a.mean_3d.shape[0])
        check("tile_windows on frame 0's binning", ok_w, detail)
        if device == "cuda":  # kernel 11 at the binning shape: device, host, launch floor
            import kernel_ab

            res["windows"] = wt = kernel_ab.windows_times(kn, *w_in)
            log_windows("animate", "frame 0's dense binning", w_in, wt)
            # the regime the frame's windows see: every pose's dense frame, twice
            inf = kernel_ab.windows_in_frame(lambda: [render_motion(
                human, buffers, prior, id_info, poses, cams, cfg, dense, (H, W))
                for _ in range(2)])
            wt["in_frame_ms"] = [1e-3 * u for u in inf]
            check("tile_windows timed inside the dense frames", len(inf) == 2 * len(poses),
                  f"{len(inf)} launches")
            log(f"[animate] tile_windows inside the dense frames (binning._windows replaced by "
                f"the kernel for this measurement): {', '.join(f'{u:.4f}' for u in inf)} us per "
                f"launch, against {1e3 * wt['device_ms']:.4f} us with outputs cycled past the L2 "
                f"and {1e3 * wt['hot_ms']:.4f} us L2-resident")

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
    ref_d, visits = kn.composite_plain_with_visits(ind.rows, bd.tile_counts, ind.origins, ones,
                                                   ind.tile_shape)
    check("composite_tiles_fwd_cm vs plain (scene+human render)", torch.equal(full_d, ref_d),
          f"{max_err(full_d, ref_d)}, bit for bit")
    pair_cull("frame", ind.rows, bd.tile_counts, ind.origins, ind.tile_shape, visits)

    # bound of the forward at this render (as phase_animate's), then of the
    # backward: operations of the replay against the bytes
    live_rows = int(torch.clamp(bd.tile_counts.long(), max=ind.rows.shape[2]).sum())
    T, P = full_d.shape[0], full_d.shape[2]
    n_visits = int(visits.sum())
    del visits, ref_d
    f_ops = n_visits * OPS_PER_VISIT / PEAK_F32_FLOPS
    f_bytes = (live_rows * BYTES_PER_ROW + T * P * BYTES_PER_PIXEL + T * 12) / PEAK_BYTES
    f_by = "operations" if f_ops >= f_bytes else "bytes"
    fwd_bound = f"{1e3 * max(f_ops, f_bytes):.6f} ms ({f_by})"
    log(f"[frame] forward kernels' bound at this render {fwd_bound} (ops {1e3 * f_ops:.6f} ms "
        f"from {n_visits} visits x {OPS_PER_VISIT}; bytes {1e3 * f_bytes:.6f} ms)")
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
        log(f"[frame] forward kernels on the same render: {fwd_ms} ms, bound {fwd_bound}")
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

    # the row-major boundary without and with origins: kernels 5 and 6's
    # wrappers (kernel 3 / 4's body without origins), forward and backward,
    # counted as a path of its own
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
        # kernels 3 and 4, then 5 and 6: the cull, and whether the forward is
        # exact here too
        log(f"[train] {fwd_name} == its plain version, bit for bit: "
            f"{torch.equal(got_f[0], accum_p) and torch.equal(got_f[1], tfinal_p)}")
        if o is None:
            pair_cull("train", quad, counts, None, tile, visits)
        else:
            pair_cull("train", quad.transpose(1, 2), counts, o, tile, visits,
                      "conic row-major cull (kernels 5 and 6, global boxes)")
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


def probe_resources() -> dict:
    """{(fwd|bwd, variant id): (registers, shared bytes, spill stores, spill
    loads, stack frame bytes)} of the stage probes' kernels, the variants'
    instantiations of composite_tiles_{fwd,bwd}_variant_kernel<V>."""
    out = {}
    for lib in ("composite", "composite_bwd"):
        found = ptxas_resources(lib, r"composite_tiles_(fwd|bwd)_variant_kernelILi(\d+)E")
        out.update({(d, int(v)): r for (d, v), r in found.items()})
    return out


def log_windows(tag: str, what: str, inputs, t: dict) -> None:
    starts, _, K, _ = inputs
    log(f"[{tag}] tile_windows on {what}, T = {starts.shape[0] - 1}, K = {K}, {t['live']} live "
        f"entries: device {1e3 * t['device_ms']:.4f} us per launch (outputs cycled past the L2; "
        f"{1e3 * t['hot_ms']:.4f} us L2-resident), launch floor {1e3 * t['floor_ms']:.4f} us, "
        f"wrapper host {1e3 * t['host_ms']:.4f} us per call, bound {1e3 * t['bound_ms']:.4f} us "
        f"(bytes): {t['bound_ms'] / t['device_ms']:.3f} of the bound; the plain gather "
        f"{1e3 * t['gather_ms']:.4f} us per call on the device")


def window_edge_cases(device):
    """[(name, starts (T + 1,) i32, rank (starts[T],) i32, K, n)]: the window
    kernel's edge cases, seeded. K = 1, 7 and 1,023 (a 16-byte vector
    crosses rows, T K % 4 != 0), 4 and 1,024; tiles whose count is 0 (first,
    last and inside) and above K; rank exactly ``starts[T]`` long (nothing
    may be read past it) and a last tile that ends there."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)
    cases = []
    for T, K in ((37, 1), (37, 7), (61, 1023), (45, 4), (33, 1024), (1, 7), (3, 1)):
        counts = rng.integers(0, 2 * K + 3, T)
        counts[0] = 0  # empty first tile
        counts[-1] = 0 if T > 2 else K + 1  # empty last tile, or one past K
        if T > 4:
            counts[T // 2] = 0
            counts[T // 3] = 3 * K + 1
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        n = 1000 + K
        rank = rng.integers(0, n, int(starts[-1])).astype(np.int32)
        cases.append((f"T={T} K={K}", torch.from_numpy(starts).to(device),
                      torch.from_numpy(rank).to(device), K, n))
    return cases


def windows_on_binning(screen, img, tile_shape, K, binning, max_pairs):
    """The window kernel on a real binning's sorted pairs against the
    binning's own windows (``binning._windows``), integer for integer:
    (equal, detail, the kernel's inputs (starts, rank, K, n))."""
    import torch

    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    n = screen.mean2d.shape[0]
    _, _, rank_sorted, starts, _, _, _, _ = bnm._compact_sorted_pairs(
        screen.mean2d, screen.radius, screen.depth, screen.in_frustum, img, *tile_shape,
        max_pairs, screen.extent)
    starts, rank = starts.int(), rank_sorted.int()
    got = kn.tile_windows(starts, rank, K, n)
    same = torch.equal(got, binning.tile_indices)
    return same, (f"(T, K) = {tuple(got.shape)} from {int(starts[-1])} sorted pairs equals the "
                  f"binning's windows: {same}"), (starts, rank, K, n)


def phase_probes(device, n=100_000, check_tiles=16, iters=10, win_inputs=None) -> dict:
    """``tools.kvariants`` and ``tools.win_probe`` as a user runs them, at
    their defaults: every variant against its plain version on the first
    ``check_tiles`` tiles (forward 1e-5 of each output's max, backward each
    row against its own max, GRAD_TOL), base (kernel 5's / 6's pair body,
    launched as a probe) bit-equal to kernel 5 and within 1e-6 of each row
    of kernel 6 (atomics: another order of summation), every exact variant
    within those limits of base; then, counters at 0 just before and read
    just after, the tools' timing runs on the whole scene, kernels 5 and 6
    timed beside base; the window kernel integer for integer against the
    binning's gather, at the tool's seeded inputs and on the scene's own
    binning; each variant's bound from its own plain version's visits on
    the whole scene, and its delta against base logged as the attribution
    of the pair body's stages, with its registers and spills. Rows 9 and 10
    of the kernels line take the mean launch of all their variants, base
    included. ``win_inputs`` (starts, rank_pad, K, n) replaces the tool's
    seeded window inputs (a rehearsal at a small size)."""
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
          f"worst row {r['max_row_rel_err']:.3e} of its own max (the same code; atomics sum "
          f"in another order; limit 1e-6)")
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
    ok, detail, _ = windows_on_binning(s["screen"], kv.IMG, s["tile_shape"], K, bn,
                                       bnm.default_max_pairs(n, s["tile_shape"][0]))
    check("tile_windows on the scene's binning", ok, detail)
    # ---- and on its edge cases
    for name, st, rk, eK, en in window_edge_cases(device):
        got = kn.tile_windows(st, rk, eK, en)
        same = torch.equal(got, kn.tile_windows_plain(st, rk, eK, en))
        check(f"tile_windows edge case {name}", same,
              f"(T, K) = {tuple(got.shape)}, {int(st[-1])} entries, rank exactly that long, "
              f"integer for integer")

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
    regs = probe_resources()
    res["kernel_stats"] = {}
    mean = lambda xs: sum(xs) / len(xs)
    for d, times, name in (("fwd", fw, "composite_tiles_fwd_variant"),
                           ("bwd", bw, "composite_tiles_bwd_variant")):
        own = list(times)  # base is the probes' own design and counts here
        bounds = {v: bound(f"{d}/{v}") for v in times}
        res["kernel_stats"][name] = {
            "ms": mean([times[v] for v in own]),
            "ms_of": f"mean per launch over the {len(own)} variants, base included",
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
    if on_card:  # kernel 11 at the probe shape: device, host, launch floor
        import kernel_ab

        wt = kernel_ab.windows_times(kn, starts, rank_pad, wK, wn)
        log_windows("probes", "win_probe's seeded inputs", (starts, rank_pad, wK, wn), wt)
        res["kernel_stats"]["tile_windows"].update(
            ms=wt["device_ms"], wrapper_loop_ms=win["ms"]["kernel"],
            ms_of="device ms per launch, CUDA graph of 200 launches into outputs cycled past "
            "the L2 (kernel_ab.windows_times)",
            **{k: wt[k] for k in ("hot_ms", "host_ms", "floor_ms", "gather_ms")})
    log(f"[probes] bytes bounds: forward {1e3 * f_bytes:.6f} ms, backward {1e3 * b_bytes:.6f} "
        f"ms; windows {1e3 * w_bytes:.6f} ms ({live_w} live entries of {wT} x {wK})")
    res["product_ms"] = probe["product"]
    for d, k in (("fwd", 5), ("bwd", 6)):
        p_ms, b_ms = probe["product"][d], probe[d]["base"]
        log(f"[probes] the probes' base {b_ms:.4f} ms against kernel {k} {p_ms:.4f} ms (the same "
            f"pair body) on the whole scene: {b_ms / p_ms:.4f}x; bound "
            f"{bound(f'{d}/base')[0]:.6f} ms")
    # the attribution of the pair body's stages: each variant against base
    for d, times in (("fwd", fw), ("bwd", bw)):
        b_ms, b_work = times["base"], work[f"{d}/base"]
        for k, v in times.items():
            w = work[f"{d}/{k}"]
            extra = f", {hits[f'{d}/{k}']} contributing" if d == "bwd" else ""
            rs = regs.get((d, kn.VARIANT_IDS[k]))
            spills = "" if rs is None or rs[2] + rs[3] == 0 else " SPILLS (delta distorted)"
            log(f"[probes] {d}/{k}: {v:.4f} ms ({v - b_ms:+.4f} = {100 * (v / b_ms - 1):+.1f}% "
                f"of base), {w} visits{extra} ({w / b_work:.3f} x base), {1e9 * v / w:.4f} ps "
                f"per visit ({100 * ((v / w) / (b_ms / b_work) - 1):+.1f}% of base's); bound "
                f"{bound(f'{d}/{k}')[0]:.6f} ms; registers, shared bytes, spill stores, spill "
                f"loads, stack bytes {rs}{spills}; plain {plain_ms[f'{d}/{k}']:.1f} ms")
    log(f"[probes] the reduction over pixels (base - nograd) is "
        f"{100 * (1 - bw['nograd'] / bw['base']):.1f}% of the backward's base")
    res["kernel_stats"]["composite_tiles_fwd_variant"]["variants_visits"] = {
        k: work[f"fwd/{k}"] for k in fw}
    res["kernel_stats"]["composite_tiles_bwd_variant"]["variants_visits"] = {
        k: work[f"bwd/{k}"] for k in bw}
    return res


# --------------------------------------------------------------------------
# the learning check: tools/convergence_demo.py at the JAX package's bars
# --------------------------------------------------------------------------

# (name, convergence_demo.run's options, the bar in dB): the two runs of the
# JAX package's tests/test_convergence.py, their steps, sizes and seeds
CONVERGENCE_RUNS = (
    ("48x64", dict(steps=300), 5.0),
    ("512x896", dict(steps=1000, H=512, W=896, rings=16, segs=24, freeze_pose=True), 8.0),
)


def phase_convergence(device, runs=CONVERGENCE_RUNS) -> dict:
    """The convergence demo as a user runs it, through the kernels (backend
    "cuda"), each run against its bar: PSNR before and after, ms per step
    past the warm-up, dropped and truncated pairs, and the launches (counters
    at 0 just before the first run and read just after the last)."""
    import torch

    from exavatar_release_tpu_torch.tools import convergence_demo as cd

    res = {"ok": True, "runs": {}}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[convergence] {name}: {detail} {'ok' if cond else 'FAIL'}")

    reset_launches()
    for name, kw, bar in runs:
        t0 = time.perf_counter()
        r = cd.run(device=device, log=lambda m, n=name: log(f"[convergence {n}] {m}"), **kw)
        gain = r.psnr_after - r.psnr_before
        res["runs"][name] = {**r._asdict(), "settings": str(r.settings), "gain_db": gain,
                             "bar_db": bar, "run_s": time.perf_counter() - t0}
        check(f"{name} ({kw})", r.steps == kw["steps"] and gain > bar,
              f"PSNR {r.psnr_before:.4f} -> {r.psnr_after:.4f} dB ({gain:+.4f}, bar +{bar}) in "
              f"{r.steps} steps, {r.ms_per_itr} ms per step past warm-up, dropped pairs "
              f"{r.dropped_pairs:.0f}, truncated {r.truncated:.0f}, "
              f"{res['runs'][name]['run_s']:.1f} s, settings at the end {r.settings}")
    if device == "cuda":
        torch.cuda.synchronize()
    res["launches"] = read_launches()
    log(f"[convergence] launches: {res['launches']}")
    check("through the kernels", device != "cuda" or all(
        res["launches"][k] > 0 for k in ("composite_tiles_fwd_cm", "composite_tiles_bwd_cm")),
        "dense forward and backward launched")
    return res


# --------------------------------------------------------------------------
# phase 8: the avatar CLIs on a subject directory
# --------------------------------------------------------------------------


def write_subject(root: str, img=(1080, 1920), n_frames: int = 3, n_points: int = 5000,
                  focal: float = 1200.0, seed: int = 0, num_expr: int = 8) -> None:
    """A seeded subject directory in the reference layout, everything
    ``data.subject.load_subject`` reads, written without cv2: COLMAP text
    (one PINHOLE camera, near-identity extrinsics per frame, a point cloud
    behind the subject), RGB frames and masks as PNG (utils/png.py),
    whole-body keypoints inside the mask, SMPL-X parameters with the subject
    2.5 m in front of the camera (``num_expr`` expression coefficients: 8 for
    the synthetic body, 50 for the released model's layout), identity tables
    and the train split."""
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
            "expr": rng.normal(0, 0.3, num_expr).tolist(), "trans": [0.0, 0.1, 2.5],
        }
        with open(os.path.join(root, "smplx_optimized", "smplx_params", f"{i}.json"), "w") as f:
            json.dump(params, f)
    for name, shape in (("shape_param.json", (16,)), ("face_offset.json", (10, 3)),
                        ("joint_offset.json", (55, 3)), ("locator_offset.json", (55, 3))):
        with open(os.path.join(root, "smplx_optimized", name), "w") as f:
            json.dump(np.zeros(shape).tolist(), f)
    with open(os.path.join(root, "train_split.txt"), "w") as f:
        f.write("".join(f"{i}.png\n" for i in range(n_frames)))


def write_human_model_dir(root: str, rings: int = 80, segs: int = 130, num_shape: int = 16,
                          num_expr: int = 8, seed: int = 0) -> dict:
    """A ``human_model_path`` directory in the released files' layout,
    written from the synthetic SMPL-X arrays (``assets_io._synthetic_arrays``)
    with numpy and pickle: ``smplx/SMPLX_MALE.npz`` (shapedirs (V, 3, 400)
    with the expression basis at columns 300+, posedirs (V, 3, P), the hands'
    means), ``smplx/SMPL-X__FLAME_vertex_ids.npy`` (the head region),
    ``smplx/MANO_SMPLX_vertex_ids.pkl``, and under ``flame/`` a FLAME model on
    the head vertices (``generic_model.pkl`` of plain arrays, its faces the
    body's faces inside the head, a 5-joint skinning), the landmark
    embeddings, ``FLAME_texture.npz`` and ``2019/generic_model.pkl``; and
    ``smplx/smplx_flip_correspondences.npz``, the mirror correspondence the
    fitting reads (``fitting.losses.synthetic_flip_correspondence``, row
    chunks). The real lip vertices (``prior.REAL_LIP_VERTEX_IDX``, up to 8977)
    need V > 8977: the default body has 10,272 vertices. Returns the arrays
    written, by file."""
    import pickle

    import numpy as np

    from exavatar_release_tpu_torch.fitting.losses import synthetic_flip_correspondence
    from exavatar_release_tpu_torch.models.smplx.assets_io import _synthetic_arrays
    from exavatar_release_tpu_torch.models.smplx.structs import SMPLX_JOINT_NAMES

    rng = np.random.default_rng(seed)
    a = _synthetic_arrays(rings, segs, num_shape, num_expr, seed=seed)
    V, J = a["v_template"].shape[0], a["lbs_weights"].shape[1]
    shapedirs = np.zeros((V, 3, 400), np.float32)
    shapedirs[:, :, :num_shape] = a["shapedirs"]
    shapedirs[:, :, 300:300 + num_expr] = a["expr_dirs"]
    P = a["posedirs"].shape[0]
    nearest = a["lbs_weights"].argmax(1)
    head = [SMPLX_JOINT_NAMES.index(n) for n in ("Head", "Jaw", "L_Eye", "R_Eye")]
    face_ids = np.where(np.isin(nearest, head))[0].astype(np.int64)
    lhand = np.where((nearest >= 25) & (nearest < 40))[0]
    rhand = np.where(nearest >= 40)[0]
    smplx = {
        "v_template": a["v_template"], "shapedirs": shapedirs,
        "posedirs": a["posedirs"].T.reshape(V, 3, P), "J_regressor": a["joint_regressor"],
        "weights": a["lbs_weights"], "f": a["faces"].astype(np.uint32),
        "lmk_faces_idx": a["lmk_faces_idx"], "lmk_bary_coords": a["lmk_bary_coords"],
        "dynamic_lmk_faces_idx": a["dyn_lmk_faces_idx"],
        "dynamic_lmk_bary_coords": a["dyn_lmk_bary_coords"],
        "hands_meanl": a["pose_mean"][75:120], "hands_meanr": a["pose_mean"][120:165],
    }
    # FLAME on the head vertices: the body's faces inside the head, a
    # 5-joint skinning (Global, Neck, Jaw, L_Eye, R_Eye) from the body's
    inv = -np.ones(V, np.int64)
    inv[face_ids] = np.arange(face_ids.size)
    inside = (inv[a["faces"]] >= 0).all(1)
    ff = inv[a["faces"][inside]]
    Vf = face_ids.size
    fw = a["lbs_weights"][face_ids]
    fl_w = np.stack([fw[:, 0], fw[:, 12], fw[:, 22], fw[:, 23], fw[:, 24]], 1) + 1e-3
    fl_w[:, 1] += fw[:, 15]  # the head's own weight rides the neck
    fl_w /= fl_w.sum(1, keepdims=True)
    fl_shapedirs = np.zeros((Vf, 3, 400), np.float32)
    fl_shapedirs[:, :, :num_shape] = rng.normal(0, 0.004, (Vf, 3, num_shape))
    fl_shapedirs[:, :, 300:300 + num_expr] = rng.normal(0, 0.004, (Vf, 3, num_expr))
    fl_shapedirs[: Vf // 8, :, 300:] = 0.0  # vertices with no expression support
    jr = np.zeros((5, Vf), np.float32)
    for j in range(5):
        near = np.argsort(-fl_w[:, j])[:6]
        jr[j, near] = 1.0 / 6
    flame = {"v_template": a["v_template"][face_ids], "shapedirs": fl_shapedirs,
             "posedirs": rng.normal(0, 4e-4, (Vf, 3, 36)).astype(np.float32),
             "J_regressor": jr, "weights": fl_w.astype(np.float32), "f": ff.astype(np.uint32)}
    F = ff.shape[0]
    static = {"lmk_face_idx": rng.integers(0, F, 51).astype(np.int64),
              "lmk_b_coords": rng.dirichlet(np.ones(3), 51)}
    dynamic = {"lmk_face_idx": rng.integers(0, F, (79, 17)).astype(np.int64),
               "lmk_b_coords": rng.dirichlet(np.ones(3), (79, 17))}
    pts = flame["v_template"]
    lo, hi = pts.min(0), pts.max(0)
    texture = {"vt": (pts[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6),
               "ft": ff.astype(np.int64)}
    for d in ("smplx", "flame/2019"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    np.savez(os.path.join(root, "smplx", "SMPLX_MALE.npz"), **smplx)
    closest_faces, bc = synthetic_flip_correspondence(a["v_template"], a["faces"])
    flip = {"closest_faces": closest_faces, "bc": bc}
    np.savez(os.path.join(root, "smplx", "smplx_flip_correspondences.npz"), **flip)
    np.save(os.path.join(root, "smplx", "SMPL-X__FLAME_vertex_ids.npy"), face_ids)
    hands = {"left_hand": lhand.astype(np.int64), "right_hand": rhand.astype(np.int64)}
    pickles = {"smplx/MANO_SMPLX_vertex_ids.pkl": hands, "flame/generic_model.pkl": flame,
               "flame/flame_static_embedding.pkl": static,
               "flame/2019/generic_model.pkl": {"shapedirs": fl_shapedirs.astype(np.float64),
                                                "weights": fl_w.astype(np.float64),
                                                "v_template": flame["v_template"]}}
    for name, obj in pickles.items():
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    np.save(os.path.join(root, "flame", "flame_dynamic_embedding.npy"), dynamic,
            allow_pickle=True)
    np.savez(os.path.join(root, "flame", "FLAME_texture.npz"), **texture)
    return {"smplx": smplx, "flame": flame, "face_ids": face_ids, "hands": hands,
            "static": static, "dynamic": dynamic, "texture": texture, "flip": flip}


def phase_apps(device, img=(1080, 1920), n_frames=3, n_points=5000, triplane=(32, 128),
               num_views=4, extra=(), human_model=True) -> dict:
    """The four CLIs as a user runs them, on a subject directory written by
    ``write_subject``: ``apps.train.main`` (native frame loader, 2 epochs of
    ``n_frames`` steps, a snapshot each), ``apps.test.main`` and
    ``apps.evaluate.main`` on the last snapshot, ``apps.animate.main`` with a
    turntable camera over ``num_views`` motion files; then the train CLI
    once more with ``--profile_dir`` past iteration 40 (the frames repeated),
    whose trace must name the compositing kernels; then, with
    ``human_model``, the four CLIs (1 epoch) with ``--human_model_path`` on a
    directory of ``write_human_model_dir`` (10,272 vertices, ~164k human
    Gaussians). Counters at 0 just before the first train run and read just
    after the last run. ``extra``: more CLI options for every call
    (``--scene_capacity`` for a rehearsal at a small size)."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from exavatar_release_tpu_torch.apps import animate, evaluate, test, train
    from exavatar_release_tpu_torch.avatar.config import AvatarConfig
    from exavatar_release_tpu_torch.data.subject import read_rgb
    from exavatar_release_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from exavatar_release_tpu_torch.utils.profiling import TRACE_FILE

    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[apps] {name}: {detail} {'ok' if cond else 'FAIL'}")

    work = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    root = os.path.join(work, "subject")
    t0 = time.perf_counter()
    write_subject(root, img, n_frames, n_points)
    H, W = img
    log(f"[apps] subject {W}x{H}, {n_frames} frames, {n_points} points written in "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--subject_root", root, "--device", device, "--triplane_ch", str(triplane[0]),
              "--triplane_res", str(triplane[1]), *extra]

    def cycle(tag, args, epochs, root=root):
        """train (``epochs``), test, evaluate and animate with ``args`` on the
        subject at ``root``."""
        out = os.path.join(work, f"out_{tag}")
        t0 = time.perf_counter()
        run = train.main(args + ["--allow_random_lpips", "--loader", "native", "--epochs",
                                 str(epochs), "--repeat", "1", "--out_dir", out])
        r = res[tag] = {"train_s": time.perf_counter() - t0}
        hist = run.history
        r["step_s"] = [h["step_s"] for h in hist]
        r["read_s"] = [h["read_s"] for h in hist]
        log(f"[apps] {tag} train: {len(hist)} steps in {r['train_s']:.2f} s; per step, step s "
            f"{[round(x, 4) for x in r['step_s']]}, read s {[round(x, 4) for x in r['read_s']]}; "
            f"totals {[round(h['total'], 4) for h in hist]}; settings at the end {run.settings}")
        model_dir = os.path.join(out, "model_dump")
        snaps = sorted(f for f in os.listdir(model_dir) if f.endswith(".npz"))
        ckpt = latest_checkpoint(model_dir)
        cfg = AvatarConfig(triplane_ch=triplane[0], triplane_res=triplane[1])
        loaded = [load_checkpoint(os.path.join(model_dir, f), cfg, device) for f in snaps]
        finite = all(np.isfinite(h["total"]) for h in hist)
        check(f"{tag} train", len(hist) == epochs * n_frames
              and snaps == [f"snapshot_{e}.npz" for e in range(epochs)]
              and [e for _, e in loaded] == list(range(epochs))
              and loaded[-1][0].itr == epochs * n_frames and finite,
              f"{len(hist)} steps, snapshots {snaps} load (epochs {[e for _, e in loaded]}), "
              f"losses finite")
        del loaded

        result_dir = os.path.join(out, "result")
        t0 = time.perf_counter()
        test.main(args + ["--ckpt", ckpt, "--out_dir", result_dir])
        r["test_s"] = time.perf_counter() - t0
        blank = []
        for i in range(n_frames):
            im = read_rgb(os.path.join(result_dir, f"{i}_scene_human_img_refined_composed.png"))
            if float(im.std()) == 0.0:
                blank.append(i)
        n_png = len([f for f in os.listdir(result_dir) if f.endswith(".png")])
        check(f"{tag} test", n_png == 9 * n_frames and not blank,
              f"{n_png} PNGs in {r['test_s']:.2f} s, blank composed frames {blank}")

        t0 = time.perf_counter()
        metrics = evaluate.main(args + ["--ckpt", ckpt, "--out_json",
                                        os.path.join(out, "metrics.json")])
        r["evaluate_s"] = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.json")) as f:
            written = json.load(f)
        check(f"{tag} evaluate", written == metrics
              and all(math.isfinite(v) for v in metrics.values()),
              f"{metrics} in {r['evaluate_s']:.2f} s")

        motion = os.path.join(work, f"motion_{tag}")
        os.makedirs(motion)
        for v in range(num_views):
            shutil.copy(os.path.join(root, "smplx_optimized", "smplx_params",
                                     f"{v % n_frames}.json"),
                        os.path.join(motion, f"{v:04d}.json"))
        t0 = time.perf_counter()
        frames = animate.main(args + ["--ckpt", ckpt, "--motion_dir", motion, "--view_rot",
                                      "--num_views", str(num_views), "--out_dir",
                                      os.path.join(out, "animate")])
        r["animate_s"] = time.perf_counter() - t0
        check(f"{tag} animate", len(frames) == num_views and all(os.path.exists(p) for p in frames),
              f"{len(frames)} frames in {r['animate_s']:.2f} s")

    reset_launches()
    cycle("synthetic", common, epochs=2)

    # --profile_dir: iterations 20-40 traced, the frames repeated past 40
    prof = os.path.join(work, "profile")
    repeat = -(-(train.PROFILE_ITRS[1] + 1) // n_frames)
    t0 = time.perf_counter()
    run = train.main(common + ["--allow_random_lpips", "--loader", "native", "--epochs", "1",
                               "--repeat", str(repeat), "--out_dir", os.path.join(work, "out_prof"),
                               "--profile_dir", prof])
    res["profile_s"] = time.perf_counter() - t0
    trace_path = os.path.join(prof, TRACE_FILE)
    found = set()
    if os.path.exists(trace_path):  # the kernels' names, read in pieces (the trace is large)
        with open(trace_path, "rb") as f:
            tail = b""
            while chunk := f.read(1 << 26):
                found |= {k for k in ALL_KERNELS if f"{k}_kernel".encode() in tail + chunk}
                tail = chunk[-256:]
    found = sorted(found)
    check("train --profile_dir", len(run.history) == repeat * n_frames
          and os.path.exists(trace_path)
          and (device != "cuda" or any(k.startswith("composite_") for k in found)),
          f"{len(run.history)} steps in {res['profile_s']:.2f} s; {trace_path} "
          f"({os.path.getsize(trace_path) if os.path.exists(trace_path) else 0} bytes) names the "
          f"kernels {found}")

    if human_model:
        hm, root50 = os.path.join(work, "human_model"), os.path.join(work, "subject_expr50")
        t0 = time.perf_counter()
        write_human_model_dir(hm)
        write_subject(root50, img, n_frames, n_points, num_expr=50)
        log(f"[apps] human_model_path: the released files' layout written from the synthetic "
            f"arrays, and a subject with 50 expression coefficients, in "
            f"{time.perf_counter() - t0:.1f} s")
        args = [root50 if a == root else a for a in common] + ["--human_model_path", hm]
        cycle("human_model_path", args, epochs=1, root=root50)
    if device == "cuda":
        torch.cuda.synchronize()
    res["launches"] = read_launches()
    log(f"[apps] launches of the CLIs' runs: {res['launches']}")
    loaded_mods = sorted({m.split(".")[0] for m in sys.modules} & {"cv2", "jax", "jaxlib"})
    check("no cv2 and no jax loaded", not loaded_mods, f"{loaded_mods or 'none'} in sys.modules")
    shutil.rmtree(work)
    return res


def write_fit_subject(root: str, human_model_path: str, n_frames: int = 64, img=(1080, 1920),
                      focal: float = 1200.0, seed: int = 0) -> dict:
    """A seeded subject for the preprocessing and fitting CLIs in the
    reference layout: per frame a posed body of ``human_model_path``'s SMPL-X
    (the root turned to face the camera, body, hands, jaw and 50 expression
    coefficients drawn, 2.5 m in front of the camera), its 135 keypoints
    projected at ``focal`` with 2 px of noise and confidences in [0.6, 1]
    (returned, for the injected keypoint detector to answer with), the poses
    perturbed by 0.05 rad as the detectors' initial estimates
    (``smplx_init/``, and ``flame_init/`` with the head's translation, the
    expression perturbed, ``shape_param.json``), an RGB frame (``images/``,
    PNG, and all frames as ``video.mp4``, mp4v at 30 fps) and its camera
    (``cam_params/``). Returns per frame the noisy keypoints ``kpt135``, the
    camera-space keypoints ``kpt3d``, the root pose ``root_pose`` and the
    camera-space vertices ``verts``, and the mesh's ``faces``."""
    import json

    import cv2
    import numpy as np
    import torch

    from exavatar_release_tpu_torch.fitting.keypoints import SMPLX_KPT_NAMES, full_keypoints
    from exavatar_release_tpu_torch.models.smplx import SMPLXParams, load_smplx_assets, \
        smplx_forward
    from exavatar_release_tpu_torch.utils.png import write_png

    H, W = img
    rng = np.random.default_rng(seed)
    a = load_smplx_assets(human_model_path, "male", device="cpu")
    for d in ("images", "cam_params", "smplx_init", "flame_init"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    head = SMPLX_KPT_NAMES.index("Head")
    noisy = lambda x, s: (np.asarray(x) + rng.normal(0, s, np.shape(x))).tolist()
    video = cv2.VideoWriter(os.path.join(root, "video.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                            (W, H))
    truth = {"kpt135": [], "kpt3d": [], "root_pose": [], "verts": [],
             "faces": a.faces.numpy().astype(np.int64)}
    for i in range(n_frames):
        pose = {"root_pose": np.asarray([math.pi, 0, 0]) + rng.normal(0, 0.05, 3),
                "body_pose": rng.normal(0, 0.1, (21, 3)), "jaw_pose": rng.normal(0, 0.05, 3),
                "leye_pose": np.zeros(3), "reye_pose": np.zeros(3),
                "lhand_pose": rng.normal(0, 0.1, (15, 3)),
                "rhand_pose": rng.normal(0, 0.1, (15, 3)),
                "expr": rng.normal(0, 0.3, a.num_expr),
                "trans": np.asarray([0.0, 0.1, 2.5]) + rng.normal(0, 0.02, 3)}
        t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in pose.items()}
        with torch.no_grad():
            out = smplx_forward(a, SMPLXParams(betas=torch.zeros(a.num_shape), **t))
            kpt = full_keypoints(out, a).numpy()
        xy = kpt[:, :2] / kpt[:, 2:3] * focal + np.asarray([W / 2, H / 2])
        kpts = np.concatenate([xy + rng.normal(0, 2.0, xy.shape),
                               rng.uniform(0.6, 1.0, (135, 1))], 1).astype(np.float32)
        truth["kpt135"].append(kpts)
        truth["kpt3d"].append(kpt)
        truth["root_pose"].append(t["root_pose"].numpy())
        truth["verts"].append(out.vertices.numpy())
        files = {
            "smplx_init": {k: noisy(pose[k], 0.05) for k in ("root_pose", "body_pose",
                                                            "lhand_pose", "rhand_pose")}
            | {"trans": noisy(pose["trans"], 0.02)},
            "flame_init": {"root_pose": noisy(np.zeros(3), 0.05),
                           "neck_pose": noisy(np.zeros(3), 0.05),
                           "jaw_pose": noisy(pose["jaw_pose"], 0.05),
                           "leye_pose": [0, 0, 0], "reye_pose": [0, 0, 0],
                           "expr": noisy(pose["expr"], 0.1), "trans": noisy(kpt[head], 0.01)},
            "cam_params": {"R": np.eye(3).tolist(), "t": [0, 0, 0], "focal": [focal, focal],
                           "princpt": [W / 2, H / 2]},
        }
        for d, payload in files.items():
            with open(os.path.join(root, d, f"{i}.json"), "w") as f:
                json.dump(payload, f)
        coarse = rng.integers(0, 256, (H // 8 + 1, W // 8 + 1, 3), np.uint8)
        frame = np.kron(coarse, np.ones((8, 8, 1), np.uint8))[:H, :W]
        write_png(os.path.join(root, "images", f"{i}.png"), frame, level=1)
        video.write(np.ascontiguousarray(frame[:, :, ::-1]))
    video.release()
    with open(os.path.join(root, "flame_init", "shape_param.json"), "w") as f:
        json.dump(rng.normal(0, 0.1, 100).tolist(), f)
    return truth


def seeded_plane(img, focal: float, seed: int = 0):
    """(H, W) float64 depth of a seeded background plane behind the subject:
    normal (nx, ny, 1) normalised with nx, ny in [-0.15, 0.15], 4.5-5.5 m
    from the camera, at pixel (i, j) along the ray ((j - W/2) / f,
    (i - H/2) / f, 1), the rays ``BkgCloudAccumulator.point_cloud``
    back-projects along."""
    import numpy as np

    H, W = img
    rng = np.random.default_rng(seed)
    n = np.asarray([*rng.uniform(-0.15, 0.15, 2), 1.0])
    n /= np.linalg.norm(n)
    d = rng.uniform(4.5, 5.5)
    ii, jj = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    return d / (n[0] * (jj - W / 2) / focal + n[1] * (ii - H / 2) / focal + n[2])


class InjectedDetectors:
    """The three detector networks of the preprocessing apps, answering frame
    after frame in the order their drivers visit the frames (by index):

    * ``infer`` (mmpose): a weaker distractor (150 px off, half the scores)
      and the frame's own keypoints in the COCO-WholeBody order, so that
      ``best_instance`` has to choose;
    * ``set_image`` / ``predict`` (SAM): the body's rendered silhouette;
    * ``depth`` (Depth-Anything): ``A - B * field`` (LARGER = closer), the
      field being the body's rendered depth over ``plane``.
    """

    def __init__(self, kpt133, silhouettes, fields, A: float, B: float):
        self.kpt133, self.sil, self.fields, self.A, self.B = kpt133, silhouettes, fields, A, B
        self.calls = {"mmpose": 0, "sam": 0, "depth": 0}

    def _next(self, what):
        i = self.calls[what]
        self.calls[what] += 1
        return i

    def infer(self, img_rgb):
        import numpy as np

        k = self.kpt133[self._next("mmpose")]
        return [(k[:, :2] + np.float32(150.0), k[:, 2] * np.float32(0.5)), (k[:, :2], k[:, 2])]

    def set_image(self, img):
        self.frame = self._next("sam")

    def predict(self, point_coords, point_labels, box, multimask_output, mask_input=None):
        import numpy as np

        m = self.sil[self.frame].cpu().numpy()
        return m[None], np.asarray([0.9]), np.zeros((1, 256, 256), np.float32)

    def depth(self, img_rgb):
        return self.rel(self._next("depth")).cpu().numpy()

    def rel(self, i):
        return (self.A - self.B * self.fields[i]).float()


def device_launches(fn) -> dict:
    """Device work of one call of ``fn`` under torch.profiler: the kernels
    and copies launched, their summed device time, the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time for e in dev) / 1e3
    return {"launches": len(dev), "device_ms": device_ms, "wall_ms": wall_ms}


def unwrap_margin(uv, mesh, faces, focal, princpt, zbuf, z_tol=0.01):
    """(Hu, Wu), float64: how far each UV pixel's unwrap decision is from its
    threshold in one frame (``fitting.unwrap.unwrap_frame``): its projected
    point from a pixel edge (the z-buffer lookup) and its depth from the
    z-buffer's plus ``z_tol`` (the visibility test)."""
    import numpy as np

    sel = np.maximum(uv.face_idx.cpu().numpy(), 0)
    tri = mesh.cpu().double().numpy()[faces.cpu().numpy()[sel]]
    pts = np.einsum("hwk,hwkc->hwc", uv.bary.cpu().double().numpy(), tri)
    z = np.maximum(pts[..., 2], 1e-6)
    f, c = focal.cpu().double().numpy(), princpt.cpu().double().numpy()
    px, py = pts[..., 0] / z * f[0] + c[0], pts[..., 1] / z * f[1] + c[1]
    H, W = zbuf.shape
    zb = zbuf.cpu().double().numpy()[np.clip(py.astype(np.int64), 0, H - 1),
                                      np.clip(px.astype(np.int64), 0, W - 1)]
    frac = lambda x: np.abs(x - np.round(x))
    return np.minimum.reduce([frac(px), frac(py), np.abs(z - (zb + z_tol))])


FIT_ITRS = (260, 40, 40)  # iterations per epoch: the CLI's 500 / 250 / 250, cut


def phase_fit(device, n_frames=64, img=(1080, 1920), focal=1200.0, itrs=FIT_ITRS, cmp_frames=4,
              unwrap_args=()) -> dict:
    """The preprocessing and fitting half as a user runs it, from a video to
    the background point cloud: ``write_human_model_dir``'s released layout
    (10,272 vertices, with the flip correspondences) and a
    ``write_fit_subject`` of ``n_frames`` frames at ``img`` (``video.mp4``;
    no ``frames/``, no keypoints, masks or ``smplx_optimized/``); then
    ``apps.preprocess.main`` at its defaults on the card, with the three
    detector networks injected (``InjectedDetectors``): the frames extracted,
    the keypoints, the masks, ``apps.fit.main`` at its defaults (batch 64,
    three epochs; ``itrs`` iterations per epoch, ``FIT_ITRS`` against the
    CLI's 500 / 250 / 250 to keep the phase near two minutes, with the
    root-only boundary at 100, the hand one at 250 and the frozen last epoch;
    None runs the CLI's schedule) with its check renders, ``apps.unwrap.main``
    at its defaults (``unwrap_args`` for a rehearsal), the smoothing and its
    check video, the depth maps and ``bkg_point_cloud.txt``. Counters at 0
    just before and read just after. Logs each step's seconds, the fit step's
    median host ms past warm-up, the peak memory, the total and
    ``smplx_kpt_proj`` losses at the first and last iteration (both must
    fall), the unwrap's coverage and the cloud's point count, and checks:

    * every output of the reference layout is there;
    * the keypoint files are the injected best instance and the masks the
      injected silhouettes, exactly;
    * the cloud has a point for each pixel that was background in some frame,
      each the mean of the frames' aligned depths and colors there: z within
      1e-4 relative + 1e-5 m of that mean recomputed in float64 from the
      seeded field (the relative depth crosses in float32, the cloud as
      ``%.6f`` text), x and y on the pixel's ray, colors the mean of the
      extracted frames within 1e-5; so its points lie on the seeded plane
      within the alignment's own error, which the fit sets: the driver
      aligns onto the fitted meshes, and frame i's scale and shift
      (alpha_i, beta_i; 1 and 0 for the seeded body) move a point
      |(alpha_i - 1) z_plane + beta_i| off the plane, logged with its
      median and largest;
    * on one frame, a relative depth that is an affine map of the seeded
      body's own render aligns back onto that render within 1e-4 m;
    * card against CPU on one frame, at an eighth of the resolution (the
      CPU's rasterizer) and each function on the same inputs:
      ``render_smplx_depth`` (the covered pixels equal but on edge ties, a
      barycentric within 1e-4 of 0 on the covering side; the depth within
      1e-5 relative), ``align_depth_to_smplx`` and the accumulated cloud
      (1e-6 relative + 1e-6), and ``umeyama`` on the layout's FLAME and
      SMPL-X face templates (1e-5); ``fitting_init``
      on the frame's keypoints: ``flame_root_init`` gives the root pose back
      within 1e-3 rad (the layout's FLAME is the SMPL-X head), the crop
      camera projects the camera-space keypoints where ``keypoints_to_crop``
      maps their projections (1e-3 px), ``smplx_trans_init`` is finite and in
      front of the camera.

    Then one ``fit_step`` on ``cmp_frames`` frames at full width on the card,
    its device launches and time (torch.profiler), and the same step on the
    CPU (losses rtol 1e-4; gradients 1e-3 of each leaf's largest plus 2^-14,
    the float32 rounding of the 1e5-weighted Laplacian term; leaves 1e-3 of
    their largest where the gradient is above 2^-12, Adam's first step being
    +-lr whatever the gradient's size), and ``unwrap_sequence`` on two frames
    at an eighth of the resolution against the CPU's (the mask equal but on
    ties: a flipped atlas face or a decision within 1e-4 of its threshold;
    the texture within 8 ulp of the frame's width where both masks are
    set)."""
    import json
    import shutil
    import tempfile

    import cv2
    import numpy as np
    import torch

    from exavatar_release_tpu_torch.apps import preprocess, run_depth_anything, run_mmpose, \
        run_sam, unwrap
    from exavatar_release_tpu_torch.apps.common import build_fit_statics_for
    from exavatar_release_tpu_torch.data import depth_cloud as dc
    from exavatar_release_tpu_torch.fitting import config as fit_config
    from exavatar_release_tpu_torch.fitting import fit as F
    from exavatar_release_tpu_torch.fitting.keypoints import SMPLX_KPT_NAMES
    from exavatar_release_tpu_torch.fitting.kpt_convert import COCO_WHOLEBODY_133_NAMES, \
        change_kpt_name
    from exavatar_release_tpu_torch.fitting.model import FitFrameData, fitting_forward
    from exavatar_release_tpu_torch.fitting.params import init_fitting_params
    from exavatar_release_tpu_torch.fitting.unwrap import build_uv_maps, unwrap_sequence
    from exavatar_release_tpu_torch.ops.mesh_raster import rasterize_mesh
    from exavatar_release_tpu_torch.utils.mesh_io import load_ply

    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[fit] {name}: {detail} {'ok' if cond else 'FAIL'}")

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    hm, root = os.path.join(work, "human_model"), os.path.join(work, "subject")
    t0 = time.perf_counter()
    write_human_model_dir(hm)
    truth = write_fit_subject(root, hm, n_frames, img, focal)
    H, W = img
    log(f"[fit] released layout (10,272 vertices, flip correspondences) and a {n_frames}-frame "
        f"{W}x{H} subject (video.mp4, images/, cameras, initial estimates) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # what the three injected networks answer: the bodies' silhouettes and
    # depths, rendered on the device, over a seeded background plane
    t0 = time.perf_counter()
    fo, pp = np.asarray([focal, focal], np.float32), np.asarray([W / 2, H / 2], np.float32)
    faces = truth["faces"]
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    body_z = [dc.render_smplx_depth(on(v), faces, fo, pp, img) for v in truth["verts"]]
    plane = on(seeded_plane(img, focal))
    fields = [torch.where(z > 0, z.double(), plane) for z in body_z]
    rng = np.random.default_rng(2)
    B = float(rng.uniform(0.5, 2.0))
    A = B * (float(plane.max()) + 1.0)
    kpt133 = [change_kpt_name(k, SMPLX_KPT_NAMES, COCO_WHOLEBODY_133_NAMES)
              for k in truth["kpt135"]]
    dets = InjectedDetectors(kpt133, [z > 0 for z in body_z], fields, A, B)
    sync()
    log(f"[fit] the injected detectors' answers rendered in {time.perf_counter() - t0:.1f} s "
        f"(plane {float(plane.min()):.3f}-{float(plane.max()):.3f} m; relative depth "
        f"{A:.4f} - {B:.4f} z)")

    args = ["--subject_root", root, "--human_model_path", hm, "--device", device]
    patched = [(fit_config.FittingConfig, "itr_opt_num"), (run_mmpose, "load_mmpose_inferencer"),
               (run_sam, "load_sam_predictor"), (run_depth_anything, "load_depth_model"),
               (unwrap, "main")]
    saved = [getattr(o, n) for o, n in patched]
    if itrs is not None:
        fit_config.FittingConfig.itr_opt_num = lambda self, epoch: itrs[epoch]
    cfg = fit_config.FittingConfig()
    sched = [cfg.itr_opt_num(e) for e in range(cfg.end_epoch)]
    run_mmpose.load_mmpose_inferencer = lambda *a, **k: dets.infer
    run_sam.load_sam_predictor = lambda *a, **k: dets
    run_depth_anything.load_depth_model = lambda *a, **k: dets.depth
    if unwrap_args:
        unwrap.main = lambda argv: saved[-1](list(argv) + list(unwrap_args))
    reset_launches()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = preprocess.main(args)
    finally:
        for (o, n), v in zip(patched, saved):
            setattr(o, n, v)
    sync()
    res["preprocess_s"] = time.perf_counter() - t0
    res["launches"] = read_launches()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    res["step_s"] = out["seconds"]
    log(f"[fit] preprocess CLI in {res['preprocess_s']:.2f} s, peak memory {res['peak_gib']} "
        f"GiB; seconds by step: " + ", ".join(f"{k} {v:.2f}" for k, v in out["seconds"].items()))
    check("injected detectors called once a frame", dets.calls == dict.fromkeys(dets.calls,
                                                                             n_frames),
          f"{dets.calls}")
    check("no compositing kernel launched", not any(res["launches"].values()),
          f"{res['launches']} (none in JAX either)")

    hist = out["fit"]
    # past warm-up: the first 5 steps of the run and the logged ones (a read each) left out
    steady = [h["step_s"] for k, h in enumerate(hist) if k >= 5 and h["itr"] % 50]
    res["fit_s"] = out["seconds"]["fit"]
    res["step_ms_median"] = 1e3 * float(np.median(steady))
    res["steps"] = len(hist)
    first, last = hist[0], hist[-1]
    log(f"[fit] fit CLI: {len(hist)} steps (schedule {sched}, batch "
        f"{min(64, n_frames)}) in {res['fit_s']:.2f} s with its check renders; step host ms "
        f"median {res['step_ms_median']:.3f} (p10 {1e3 * np.percentile(steady, 10):.3f}, p90 "
        f"{1e3 * np.percentile(steady, 90):.3f})")
    for k in ("total", "smplx_kpt_proj"):
        res[k] = (first[k], last[k])
        check(f"{k} falls", np.isfinite([first[k], last[k]]).all() and last[k] < first[k],
              f"{first[k]:.6f} at the first iteration, {last[k]:.6f} at the last")
    for e in range(cfg.end_epoch):  # each epoch's first and last totals
        ep = [h["total"] for h in hist if h["epoch"] == e]
        log(f"[fit]   epoch {e}: total {ep[0]:.6f} -> {ep[-1]:.6f} over {len(ep)} iterations")
    res["coverage"] = out["coverage"]
    check("unwrap", out["coverage"] is not None and 0 < out["coverage"] <= 1,
          f"{out['seconds']['unwrap']:.2f} s, coverage {out['coverage']}")

    # every output of the reference layout
    opt = os.path.join(root, "smplx_optimized")
    per_frame = {"frames": "{}.png", "keypoints_whole_body": "{}.json", "masks": "{}.png",
                 "depthmaps": "{}.png", "smplx_optimized/smplx_params": "{}.json",
                 "smplx_optimized/meshes": "{}_smplx.ply",
                 "smplx_optimized/renders": "{}_smplx.jpg",
                 "smplx_optimized/meshes_smoothed": "{}_smplx.ply",
                 "smplx_optimized/renders_smoothed": "{}_smplx.jpg"}
    missing = [f"{d}/{n.format(i)}" for d, n in per_frame.items() for i in range(n_frames)
               if not os.path.exists(os.path.join(root, d, n.format(i)))]
    missing += [n for n in ("smplx_optimized/shape_param.json", "smplx_optimized/face_offset.json",
                            "smplx_optimized/joint_offset.json",
                            "smplx_optimized/locator_offset.json",
                            "smplx_optimized/face_texture.png",
                            "smplx_optimized/face_texture_mask.png", "smplx_optimized.mp4",
                            "smplx_optimized_smoothed.mp4", "keypoints_whole_body.mp4",
                            "masks.mp4", "depthmaps.mp4", "bkg_point_cloud.txt")
                if not os.path.exists(os.path.join(root, n))]
    check("the reference layout", not missing,
          f"{len(per_frame)} directories of {n_frames} files and 12 more; missing "
          f"{missing[:5] or 'none'}")

    # the detectors' files: the injected best instance, the silhouettes
    t0 = time.perf_counter()
    kp_ok = mask_ok = True
    for i in range(n_frames):
        with open(os.path.join(root, "keypoints_whole_body", f"{i}.json")) as f:
            kp_ok &= bool(np.array_equal(np.asarray(json.load(f), np.float32), kpt133[i]))
        m = cv2.imread(os.path.join(root, "masks", f"{i}.png"), cv2.IMREAD_GRAYSCALE)
        mask_ok &= bool(np.array_equal(m, dets.sil[i].cpu().numpy().astype(np.uint8) * 255))
    check("keypoint files are the best instance", kp_ok,
          f"{n_frames} files equal the injected keypoints (the distractor has half the scores)")
    check("mask files are the silhouettes", mask_ok, f"{n_frames} masks equal, pixel for pixel")

    # the cloud, against its mean recomputed in float64 from the seeded field
    with open(os.path.join(root, "bkg_point_cloud.txt")) as f:
        cloud = np.fromstring(f.read(), sep=" ").reshape(-1, 6)
    res["cloud_points"] = cloud.shape[0]
    acc = {k: torch.zeros((H, W), dtype=torch.float64, device=device) for k in ("z", "n")}
    acc["rgb"] = torch.zeros((H, W, 3), dtype=torch.float64, device=device)
    dev_max = torch.zeros((H, W), dtype=torch.float64, device=device)
    ab = []
    for i in range(n_frames):
        verts, mfaces = load_ply(os.path.join(opt, "meshes_smoothed", f"{i}_smplx.ply"))
        s = dc.render_smplx_depth(on(verts), mfaces, fo, pp, img).double()
        fg, field = s > 0, fields[i]
        if int(fg.sum()) < 16:  # the driver keeps the relative depth
            rel = dets.rel(i).double()
            aligned = float(rel.max()) - rel
            ab.append((float("nan"), float("nan")))
        else:
            mad = lambda x: torch.abs(x - x.mean()).mean()
            alpha = float(mad(s[fg]) / mad(field[fg]))
            beta = float(s[fg].mean()) - alpha * float(field[fg].mean())
            aligned = alpha * field + beta
            ab.append((alpha, beta))
        bkg = ~dets.sil[i]
        frame = cv2.imread(os.path.join(root, "frames", f"{i}.png"))[:, :, ::-1]
        acc["z"] += aligned * bkg
        acc["n"] += bkg
        acc["rgb"] += on(frame.copy()).double() / 255.0 * bkg[..., None]
        dev_max = torch.where(bkg, torch.maximum(dev_max, (aligned - plane).abs()), dev_max)
    seen = acc["n"] > 0
    n_seen = int(seen.sum())
    ii, jj = torch.nonzero(seen, as_tuple=True)
    z_want = (acc["z"] / acc["n"].clamp(min=1))[seen].cpu().numpy()
    rgb_want = (acc["rgb"] / acc["n"].clamp(min=1)[..., None])[seen].cpu().numpy()
    z_plane = plane[seen].cpu().numpy()
    ok_shape = cloud.shape[0] == n_seen
    if ok_shape:
        z = cloud[:, 2]
        z_err = np.abs(z - z_want) / (1e-4 * np.abs(z_want) + 1e-5)
        ray = np.stack([(jj.cpu().numpy() - W / 2) / focal, (ii.cpu().numpy() - H / 2) / focal],
                       1) * z[:, None]
        xy_err = float(np.abs(cloud[:, :2] - ray).max())
        rgb_err = float(np.abs(cloud[:, 3:] - rgb_want).max())
        off = np.abs(z - z_plane)
        bound = dev_max[seen].cpu().numpy() + 1e-4 * z_plane + 1e-5
    alphas = [a for a, _ in ab if np.isfinite(a)]
    betas = [b for _, b in ab if np.isfinite(b)]
    check("cloud: a point per background pixel", ok_shape,
          f"{cloud.shape[0]} points, {n_seen} pixels background in some frame of {H * W}")
    if ok_shape:
        check("cloud: the frames' aligned depth and colors", z_err.max() <= 1 and xy_err <= 1e-4
              and rgb_err <= 1e-5,
              f"z worst {float(z_err.max()):.3f} of its tolerance (1e-4 z + 1e-5 m), x/y off "
              f"the pixel's ray by {xy_err:.2e} m, colors by {rgb_err:.2e}")
        check("cloud: on the seeded plane within the alignment's error",
              (off <= bound).all(),
              f"|z - z_plane| median {float(np.median(off)):.4f} m, largest "
              f"{float(off.max()):.4f} m ({float((off / z_plane).max()):.2%}); the fitted "
              f"meshes' scale alpha {min(alphas, default=float('nan')):.4f}-"
              f"{max(alphas, default=float('nan')):.4f} and shift beta "
              f"{min(betas, default=float('nan')):.4f}-{max(betas, default=float('nan')):.4f} m "
              f"(1 and 0 for the seeded body; {n_frames - len(alphas)} frames without 16 mesh "
              f"pixels)")
    log(f"[fit] the keypoint, mask and cloud checks in {time.perf_counter() - t0:.1f} s")

    # one frame: a relative depth that is an affine map of the body's own
    # render aligns back onto it; then card against CPU
    t0 = time.perf_counter()
    rel0 = dets.rel(0)
    hi = float(rel0.max())
    exact = dc.align_depth_to_smplx(hi - rel0, body_z[0])
    fg0 = body_z[0] > 0
    err0 = float((exact - body_z[0])[fg0].abs().max())
    check("alignment onto the render of the same mesh", err0 <= 1e-4,
          f"{int(fg0.sum())} mesh pixels within {err0:.2e} m (limit 1e-4)")
    # the same inputs on the card and on the CPU, at an eighth of the
    # resolution (the CPU's rasterizer): each function's own inputs shared
    sm, fo8, pp8 = (H // 8, W // 8), fo / 8, pp / 8
    v0 = torch.from_numpy(truth["verts"][0])
    z8 = dc.render_smplx_depth(v0, faces, fo8, pp8, sm)
    rel8 = (A - B * torch.where(z8 > 0, z8.double(), torch.from_numpy(seeded_plane(sm, focal / 8)))
            ).float()
    low8 = float(rel8.max()) - rel8
    al8 = dc.align_depth_to_smplx(low8, z8)
    col8 = torch.from_numpy(np.random.default_rng(3).uniform(size=sm + (3,)).astype(np.float32))
    cpu = {}
    for r, d in (("card", device), ("cpu", "cpu")):
        frags = rasterize_mesh(v0.to(d), torch.from_numpy(faces).to(d),
                               torch.from_numpy(fo8).to(d), torch.from_numpy(pp8).to(d), sm)
        z = dc.render_smplx_depth(v0.to(d), faces, fo8, pp8, sm)
        al = dc.align_depth_to_smplx(low8.to(d), z8.to(d))
        acc1 = dc.BkgCloudAccumulator(sm, d)
        acc1.add(al8.to(d), col8.to(d), (z8 > 0).float().to(d))
        cpu[r] = (frags.bary.min(-1).values.cpu().numpy(), z.cpu().numpy(), al.cpu().numpy(),
                  acc1.point_cloud(fo8, pp8).cpu().numpy())
    (bc, zc, ac, cc), (bg, zg, ag, cg) = cpu["cpu"], cpu["card"]
    flip = (zc > 0) != (zg > 0)
    ties = np.where(zg > 0, bg, bc)[flip]
    both = (zc > 0) & (zg > 0)
    z_rel = float((np.abs(zg - zc)[both] / zc[both]).max())
    check("render_smplx_depth card vs CPU", (ties < 1e-4).all() and z_rel <= 1e-5,
          f"at {sm[1]}x{sm[0]}: {int(flip.sum())} of {int((zc > 0).sum())} covered pixels flip "
          f"(all edge ties), depth {z_rel:.2e} relative")
    close = lambda a, b: bool(a.shape == b.shape and (np.abs(a - b) <= 1e-6 + 1e-6 * np.abs(b))
                              .all())
    check("align_depth_to_smplx and the cloud card vs CPU", close(ag, ac) and close(cg, cc),
          f"aligned {float(np.abs(ag - ac).max()):.2e}, cloud of {cc.shape[0]} points "
          f"{float(np.abs(cg - cc).max()) if cg.shape == cc.shape else 'shapes differ'}")

    from exavatar_release_tpu_torch.core.geometry import umeyama
    from exavatar_release_tpu_torch.core.rotations import axis_angle_to_matrix
    from exavatar_release_tpu_torch.data import fitting_init as fi
    from exavatar_release_tpu_torch.data.subject import bbox_from_keypoints
    from exavatar_release_tpu_torch.models.smplx import load_flame_assets, load_prior_tables

    st = build_fit_statics_for(hm, "cpu")
    sm_t = st.smplx_assets.v_template.numpy()
    fl_t = load_flame_assets(hm, device="cpu").v_template.numpy()
    fidx = np.asarray(load_prior_tables(hm)["face_vertex_idx"])
    root0, k0 = truth["root_pose"][0], truth["kpt135"][0]
    R0 = axis_angle_to_matrix(torch.from_numpy(root0)).numpy()
    tgt = (sm_t @ R0.T)[fidx]
    um = {r: [x.cpu().numpy() for x in umeyama(torch.from_numpy(fl_t).to(d),
                                                torch.from_numpy(tgt).to(d), False)]
          for r, d in (("card", device), ("cpu", "cpu"))}
    um_err = max(float(np.abs(g - c).max()) for g, c in zip(um["card"], um["cpu"]))
    pose, _ = fi.flame_root_init(root0, np.asarray([0.0, 0.1, 2.5], np.float32), sm_t, fidx, fl_t)
    Rf = axis_angle_to_matrix(torch.from_numpy(pose)).numpy()
    ang = float(np.arccos(np.clip((np.trace(Rf.T @ R0) - 1) / 2, -1, 1)))
    bbox = fi.set_aspect_ratio(bbox_from_keypoints(k0[:, :2], (k0[:, 2] > 0.2).astype(np.float32)))
    fc, pc = fi.crop_camera_intrinsics(fo, pp, bbox, (256, 256))
    k3 = truth["kpt3d"][0]
    proj = k3[:, :2] / k3[:, 2:3]
    crop_err = float(np.abs(proj * fc + pc - fi.keypoints_to_crop(proj * fo + pp, bbox,
                                                                  (256, 256))).max())
    t_init = fi.smplx_trans_init(k0, fo, pp)
    check("fitting_init on the frame", um_err <= 1e-5 and ang <= 1e-3 and crop_err <= 1e-3
          and np.isfinite(t_init).all() and t_init[2] > 0,
          f"umeyama card vs CPU {um_err:.2e}; flame_root_init {ang:.2e} rad off the root pose; "
          f"crop camera {crop_err:.2e} px; smplx_trans_init {np.round(t_init, 3).tolist()} "
          f"(the body at [0, 0.1, 2.5])")
    log(f"[fit] one-frame checks in {time.perf_counter() - t0:.1f} s")

    # one step at full width from one state, on the card and on the CPU
    t_cmp = time.perf_counter()
    rng = np.random.default_rng(1)
    devs = {"cpu": "cpu", "card": device}
    statics = {r: build_fit_statics_for(hm, d) for r, d in devs.items()}
    st = statics["cpu"]
    E, Sf = st.flame_assets.num_expr, st.flame_assets.num_shape
    f32 = lambda x: np.asarray(x, np.float32)
    pose = lambda n: rng.normal(0, 0.1, n)
    smplx_init = [{"root_pose": np.asarray([math.pi, 0, 0]) + pose(3), "body_pose": pose((21, 3)),
                   "lhand_pose": pose((15, 3)), "rhand_pose": pose((15, 3)),
                   "trans": [0.0, 0.1, 2.5]} for _ in range(cmp_frames)]
    flame_init = [{"root_pose": pose(3), "neck_pose": pose(3), "jaw_pose": pose(3),
                   "leye_pose": np.zeros(3), "reye_pose": np.zeros(3), "expr": pose(E),
                   "trans": [0.0, 0.6, 2.5]} for _ in range(cmp_frames)]
    fr = dict(kpt_img=f32(rng.uniform(0, 8, (cmp_frames, 135, 2))),
              kpt_valid=f32(rng.uniform(size=(cmp_frames, 135, 1)) > 0.2),
              focal_proj=f32(np.full((cmp_frames, 2), 4.0)),
              princpt_proj=f32(np.full((cmp_frames, 2), 4.0)),
              flame_valid=np.ones(cmp_frames, bool),
              init_smplx_pose=f32(rng.normal(0, 0.1, (cmp_frames, 55, 3))),
              init_flame_pose=f32(rng.normal(0, 0.1, (cmp_frames, 4, 3))),
              init_flame_shape=f32(rng.normal(0, 0.5, (cmp_frames, Sf))),
              init_flame_expr=f32(rng.normal(0, 0.5, (cmp_frames, E))))
    # the layout's FLAME is the SMPL-X head itself: at zero shapes and offsets
    # the two zero-pose meshes coincide and every L1 coupling sits at its kink,
    # where the last bit picks the gradient's sign; seeded identity moves off it
    ident = {k: f32(rng.normal(0, s, n)) for k, s, n in (
        ("smplx_shape", 0.3, st.smplx_assets.num_shape), ("flame_shape", 0.3, Sf),
        ("face_offset", 0.002, (st.flame_assets.num_vertices, 3)),
        ("joint_offset", 0.005, (st.smplx_assets.num_joints, 3)),
        ("locator_offset", 0.005, (st.smplx_assets.num_joints, 3)))}
    opt = F.make_fit_optimizer()
    runs = {}
    for r, d in devs.items():
        def fresh():
            p = init_fitting_params(smplx_init, flame_init, np.zeros(Sf),
                                    st.smplx_assets.num_shape, st.flame_assets.num_vertices,
                                    st.smplx_assets.num_joints, d)
            for k, v in ident.items():
                setattr(p, k, torch.tensor(v, device=d))  # a copy: the step moves it
            return F.init_fit_state(p, opt)
        frames = FitFrameData(**{k: torch.from_numpy(v).to(d) for k, v in fr.items()})
        rows = torch.arange(cmp_frames, device=d)
        step = lambda state: F.fit_step(state, statics[r], frames, rows, opt, 1e-2, False, True,
                                        False, False)
        if r == "card" and cuda:  # launches and device time of a step, warm
            state = fresh()
            for _ in range(3):
                step(state)
            prof = device_launches(lambda: step(state))
            res["launches_per_step"] = prof["launches"]
            log(f"[fit] fit_step at full width, {cmp_frames} frames: {prof['launches']} device "
                f"launches, device busy {prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
                f"wall ({100 * prof['device_ms'] / prof['wall_ms']:.1f}%)")
        state = fresh()
        losses = fitting_forward(state.params, statics[r], frames, rows, False, False)
        grads = torch.autograd.grad(sum(losses.values()), list(state.params.named().values()))
        _, l1 = step(state)
        runs[r] = ({k: float(v) for k, v in l1.items()}, [g.cpu().numpy() for g in grads],
                   {k: v.detach().cpu().numpy() for k, v in state.params.named().items()})
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs["card"]
    loss_ok = all(abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-6 for k in lc)
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc)
    check("fit_step card vs CPU, losses", loss_ok,
          f"worst relative {loss_err:.3e} over {len(lc)} terms (rtol 1e-4, atol 1e-6)")
    worst_g, worst_p = [], []
    for (k, c), g, want in zip(pc.items(), gg, gc):
        scale = float(np.abs(want).max())
        worst_g.append((float(np.abs(g - want).max()) / max(scale, 1e-30), k,
                        bool((np.abs(g - want) <= 1e-3 * scale + 2.0 ** -14).all())))
        d = np.abs(pg[k] - c)[np.abs(want) > 2.0 ** -12]
        worst_p.append((float(d.max()) / float(np.abs(c).max()) if d.size else 0.0, k,
                        bool((d <= 1e-3 * np.abs(c).max()).all())))
    check("fit_step card vs CPU, gradients", all(ok for *_, ok in worst_g),
          "worst leaves " + ", ".join(f"{k} {e:.2e}" for e, k, _ in sorted(worst_g)[-3:]))
    check("fit_step card vs CPU, leaves", all(ok for *_, ok in worst_p),
          "worst leaves " + ", ".join(f"{k} {e:.2e}" for e, k, _ in sorted(worst_p)[-3:]))

    # unwrap_sequence on two frames: the face of the detectors' initial
    # estimate (the fit's translations live in its normalized space), the
    # frames and cameras at an eighth of the resolution and a 256x256 atlas
    # (the CPU's rasterizer)
    from exavatar_release_tpu_torch.apps.common import build_prior_for, face_mesh_for
    from exavatar_release_tpu_torch.data.subject import read_rgb
    from exavatar_release_tpu_torch.models.smplx import SMPLXParams, smplx_forward

    prior = build_prior_for(hm, "male", "cpu")
    faces, vertex_uv, face_uv = face_mesh_for(hm, prior)
    a, fv = prior.assets, prior.face_vertex_idx.long()
    ins = {"meshes": [], "imgs": [], "focals": [], "princpts": []}
    for fid in (0, 1):
        with open(os.path.join(root, "smplx_init", f"{fid}.json")) as f:
            sp = {k: torch.tensor(v, dtype=torch.float32) for k, v in json.load(f).items()}
        with open(os.path.join(root, "cam_params", f"{fid}.json")) as f:
            cp = json.load(f)
        z = lambda *n: torch.zeros(n)
        with torch.no_grad():
            ins["meshes"].append(smplx_forward(a, SMPLXParams(
                betas=z(a.num_shape), expr=z(a.num_expr), jaw_pose=z(3), leye_pose=z(3),
                reye_pose=z(3), **sp), with_landmarks=False).vertices[fv])
        ins["imgs"].append(torch.from_numpy(
            read_rgb(os.path.join(root, "images", f"{fid}.png"))[:, ::8, ::8].copy()))
        ins["focals"].append(torch.tensor(cp["focal"]) / 8)
        ins["princpts"].append(torch.tensor(cp["princpt"]) / 8)
    ins = {k: torch.stack(v) for k, v in ins.items()}
    H, W = ins["imgs"].shape[2:]
    faces_t = torch.from_numpy(np.asarray(faces, np.int64))
    uv_size = int(dict(zip(unwrap_args[::2], unwrap_args[1::2])).get("--uv_size", 256))
    out = {}
    for r, d in devs.items():
        uv = build_uv_maps(torch.from_numpy(vertex_uv).to(d),
                           torch.from_numpy(np.asarray(face_uv)).to(d), (uv_size, uv_size))
        tex, mask = unwrap_sequence(uv, ins["meshes"].to(d), faces_t.to(d), ins["imgs"].to(d),
                                    ins["focals"].to(d), ins["princpts"].to(d))
        out[r] = (uv, uv.face_idx.cpu().numpy(), uv.bary.cpu().numpy(), tex.cpu().numpy(),
                  mask.cpu().numpy()[0] > 0)
    (uv_cpu, fc, bc_, tc, mc), (_, fg, bg_, tg, mg) = out["cpu"], out["card"]
    # a flipped atlas face: covered on both sides (the atlas is drawn at one
    # depth) or on an edge; a flipped mask pixel: a flipped face or a decision
    # within 1e-4 of its threshold in one of the frames
    uv_tie = ((fc >= 0) & (fg >= 0)) | (bc_.min(-1) < 1e-4) | (bg_.min(-1) < 1e-4)
    margin = np.minimum.reduce([
        unwrap_margin(uv_cpu, m, faces_t, fo, pp, rasterize_mesh(m, faces_t, fo, pp, (H, W)).zbuf)
        for m, fo, pp in zip(ins["meshes"], ins["focals"], ins["princpts"])])
    tie = (fc != fg) | (margin < 1e-4)
    same = mc & mg & (fc == fg)
    tex_err = float(np.abs(tg - tc)[:, same].max()) if same.any() else 0.0
    # the sample points' coordinates carry the float32 rounding of values up
    # to W (the card contracts into FMAs where the CPU does not), and the
    # frame's 8x8 blocks step by up to 1 between neighbouring pixels
    tex_tol = 8 * float(np.spacing(np.float32(W)))
    check("unwrap_sequence card vs CPU",
          ((fc == fg) | uv_tie).all() and (mc == mg)[~tie].all() and tex_err <= tex_tol
          and (mc & ~tie).mean() > 0.01,
          f"atlas faces differing {int((fc != fg).sum())} (all ties), mask pixels differing "
          f"{int((mc != mg).sum())} of {int(mc.sum())} set (all ties), texture max abs diff "
          f"{tex_err:.3e} where both are set on one face (limit {tex_tol:.3e}: 8 ulp of W = "
          f"{W}); card against CPU in {time.perf_counter() - t_cmp:.1f} s")
    shutil.rmtree(work)
    return res


# --------------------------------------------------------------------------
# phase 11: parallel/ (the sharded renders, the exchange, the data x tile step)
# --------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def input_grad_cols(got, want) -> float:
    """Input gradients (N, c) against the reference's, column by column:
    the worst of each column's max abs difference over its own max |ref|."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        for c in range(w.shape[1]):
            worst = max(worst, own_scale_err(g[:, c], w[:, c]))
    return worst


def phase_parallel(device, bands=4, timing_iters=2, scale_kw=None, cli_img=(1080, 1920),
                   cli_points=5000, cli_extra=(), **setup_kw) -> dict:
    """``parallel/`` at the train-mode frame's width (``build_frame``: 20,000
    scene Gaussians and the ~164k-Gaussian human at 1920x1080, tiles 32x128):

    (a) on a local mesh of ``bands`` repeats of the card, the largest render
        of the frame (scene + refined human) through ``rasterize_sharded`` and
        ``rasterize_gaussian_sharded``, dense (K sized so that nothing
        truncates, as ``tools.multichip_scale`` sizes it) and pair-major,
        against the single-device render through the same kernels: outputs
        (TOL; bit-equality logged), the input gradients under phase_frame's
        cotangents (an L1 image loss, a mask mean, a depth mean) column by
        column within GRAD_TOL, no pair dropped, the exchange's overflow 0 at
        the automatic cap; each render timed beside the single-device one;
    (b) ``tools.multichip_scale.check_sharded_scale`` at its defaults (100,000
        Gaussians at 512x896) on the same mesh, with its own assertions;
    (c) a ``torch.distributed`` world of one rank (NCCL on the card):
        ``dp_tile_train_step`` at data = 1, tile = 1, with and without
        ``gaussian_shard``, against ``train_step`` on the same frame and
        background (total within 1e-5 relative, as two runs of one step in
        phase_train; each gradient leaf, read from Adam's first moment,
        within DP_LEAF_TOL of its own max, beside ``train_step``'s own
        spread from one run to the next; at most 0.5% of a leaf's elements
        moved by more than half its largest update, multichip_scale's bound;
        the statistics equal; the same kernel launches as ``train_step``);
        then ``apps.train.main --mesh data=1,tile=1 --gaussian_shard`` for
        one epoch on a subject of ``write_subject``.

    A process mesh of more than one rank on cards needs more than one card;
    this phase runs on one. The launches it reports are the parallel path's
    own: those of the sharded renders of (a) (each call ``bands`` launches
    of its forward and of its backward kernel, no other), of the steps of
    (c) and of the CLI; the single-device renders and ``train_step`` they
    are held against, and (b), which mixes both, are not counted."""
    import copy
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from exavatar_release_tpu_torch.apps import train as train_cli
    from exavatar_release_tpu_torch.ops.rasterizer import api
    from exavatar_release_tpu_torch.parallel import (
        dp_tile_train_step, init_distributed, make_host_mesh, make_mesh,
        rasterize_gaussian_sharded, rasterize_sharded,
    )
    from exavatar_release_tpu_torch.parallel.sharded_raster import _bands
    from exavatar_release_tpu_torch.tools.multichip_scale import check_sharded_scale
    from exavatar_release_tpu_torch.train import loop as tl
    from exavatar_release_tpu_torch.train.optim import make_optimizer

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res = {"ok": True}

    def check(name, cond, detail):
        res["ok"] &= bool(cond)
        log(f"[parallel] {name}: {detail} {'ok' if cond else 'FAIL'}")

    t0 = time.perf_counter()
    cfg, trainables, scene_aux, bundle, frame, bg = build_frame(device, **setup_kw)
    H, W = frame.img.shape[1:]
    ppg, dense_k, (_, _, both) = find_capacities(trainables, scene_aux, bundle, frame, cfg,
                                                 "parallel")
    log(f"[parallel] setup {time.perf_counter() - t0:.1f} s")
    cam, ones = frame.cam, torch.ones(3, device=device)
    args = (both.mean_3d, both.scale, both.rotation, both.opacity, both.rgb)
    target = frame.img.permute(1, 2, 0)

    def value_and_grads(render):
        xs = [a.detach().clone().requires_grad_(True) for a in args]
        r = render(*xs, both.live, cam, (H, W), ones)
        loss = (r["img"] - target).abs().mean() + r["mask"].mean() + r["depth"].mean()
        return r, loss.detach(), torch.autograd.grad(loss, xs)

    def timed(render):
        out = value_and_grads(render)
        sync()
        t0 = time.perf_counter()
        for _ in range(timing_iters):
            value_and_grads(render)
        sync()
        return out, 1e3 * (time.perf_counter() - t0) / max(timing_iters, 1)

    def launches_of(fn):
        """fn() and the kernel launches it made."""
        sync()
        before = read_launches()
        out = fn()
        sync()
        return out, {k: v - before[k] for k, v in read_launches().items()}

    par_launches = dict.fromkeys(ALL_KERNELS, 0)

    def counted(fn):
        """launches_of(fn), its launches added to the parallel path's."""
        out, made = launches_of(fn)
        for k, v in made.items():
            par_launches[k] += v
        return out, made

    mesh = make_mesh((bands,), ("tile",), [torch.device(device)] * bands)
    th, tw = 32, 128
    # the band's pair-sort binning gives each Gaussian one lane per tile of a band
    lanes = (_bands(H, api.RasterizeSettings(), bands) // th) * (-(-W // tw))
    modes = {"dense": api.RasterizeSettings(max_per_tile=dense_k, pairs_per_gaussian=ppg,
                                            max_tiles_per_gaussian=lanes),
             "pair_major": api.RasterizeSettings(pair_major=True, pairs_per_gaussian=ppg)}
    kernel_of = {"dense": ("composite_tiles_fwd_cm", "composite_tiles_bwd_cm"),
                 "pair_major": ("composite_pairs_fwd_rg", "composite_pairs_bwd_rg")}
    res["renders"] = {}
    for mode, s in modes.items():
        (ref, v_ref, g_ref), ms_single = timed(lambda *a: api.rasterize(*a, s))
        times = {"single": ms_single}
        for name, fn in (("tile_sharded", rasterize_sharded),
                         ("gaussian_sharded", rasterize_gaussian_sharded)):
            ((r, v, g), times[name]), made = counted(
                lambda: timed(lambda *a: fn(*a, mesh, "tile", s)))
            calls = 1 + timing_iters
            want = {k: calls * bands if k in kernel_of[mode] else 0 for k in ALL_KERNELS}
            check(f"{name} {mode} launches", not on_card or made == want,
                  f"{ {k: v for k, v in made.items() if v} } in {calls} value+grad calls, "
                  f"{bands} of each of {kernel_of[mode]} a call and no other")
            err = {k: float((r[k] - ref[k]).detach().abs().max()) for k in TOL}
            bit = all(bool(torch.equal(r[k], ref[k])) for k in TOL)
            g_err = input_grad_cols(g, g_ref)
            ovf = r.get("exchange_overflow")
            ok = (within(err, TOL) and g_err <= GRAD_TOL and int(r["n_dropped"]) == 0
                  and int(ref["n_dropped"]) == 0 and (ovf is None or int(ovf.sum()) == 0))
            check(f"{name} {mode} on {bands} bands vs single device", ok,
                  f"outputs {err} (bit-equal: {bit}); input gradients worst column "
                  f"{g_err:.3e} of its own max (limit {GRAD_TOL}); loss {float(v):.7f} vs "
                  f"{float(v_ref):.7f}; dropped {int(r['n_dropped'])}"
                  + ("" if ovf is None else
                     f"; exchange overflow per band {ovf.tolist()}, exchange_bytes "
                     f"{float(r['exchange_bytes']):.0f} per band each way"))
            del r, g
        log(f"[parallel] {mode} value+grad ms (mean of {timing_iters}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
        res["renders"][mode] = times
        del ref, g_ref

    # (b) the JAX tool's realistic-shape check, on the same mesh
    t0 = time.perf_counter()
    report = check_sharded_scale(mesh, log=lambda m: log(f"[parallel] {m}"), **(scale_kw or {}))
    res["multichip_scale"] = report
    log(f"[parallel] multichip_scale report ({time.perf_counter() - t0:.1f} s): {report}")

    # (c) a world of one rank: the data x tile step and the CLI's --mesh
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        pmesh = make_host_mesh(d_tile=1)
        log(f"[parallel] {pmesh} (backend {dist.get_backend()}); a process mesh of more than "
            f"one rank on cards needs more than one card, which this run does not have")
        opt = make_optimizer(trainables, cfg, float(scene_aux.cam_dist_radius), 100)
        state0 = tl.init_train_state(trainables, scene_aux, opt)
        settings = modes["pair_major"]
        old = {k: p.detach().clone() for k, p in trainables.named_parameters()}
        step = lambda: tl.train_step(copy.deepcopy(state0), bundle, frame, opt, cfg,
                                     is_warmup=False, settings=settings, bg=bg)
        (ref, ref_losses), ref_made = launches_of(step)
        # how far train_step is from itself, run to run (index_add_ and the
        # backward kernels sum with atomics)
        again, _ = step()
        spread = max(((k, own_scale_err(again.opt_state.mu[k], ref.opt_state.mu[k]))
                      for k in ref.opt_state.mu), key=lambda kv: kv[1])
        log(f"[parallel] train_step against itself, run to run: worst gradient leaf "
            f"{spread[0]} {spread[1]:.3e} of its own max")
        del again
        for gs in (False, True):
            (st, losses), made = counted(lambda: dp_tile_train_step(
                copy.deepcopy(state0), bundle, [frame], bg[None], opt, cfg, pmesh,
                is_warmup=False, settings=dataclasses.replace(settings, gaussian_shard=gs)))
            rel = abs(float(losses["total"]) - float(ref_losses["total"])) / abs(
                float(ref_losses["total"]))
            mu_err = max(((k, own_scale_err(st.opt_state.mu[k], ref.opt_state.mu[k]))
                          for k in ref.opt_state.mu), key=lambda kv: kv[1])
            ref_p, flips = dict(ref.trainables.named_parameters()), {}
            for k, p in st.trainables.named_parameters():
                step_ref = ref_p[k].detach() - old[k]
                top = float(step_ref.abs().max())
                du = (p.detach() - old[k]) - step_ref
                flips[k] = float((du.abs() > 0.5 * top).float().mean()) if top > 0 else 0.0
            worst = max(flips, key=flips.get)
            same_stats = bool(torch.equal(st.scene_aux.track_cnt, ref.scene_aux.track_cnt))
            same_launches = made == ref_made and (not on_card or any(made.values()))
            check(f"dp_tile_train_step (data 1, tile 1{', gaussian_shard' if gs else ''}) vs "
                  f"train_step", rel <= 1e-5 and mu_err[1] <= DP_LEAF_TOL
                  and flips[worst] <= 0.005 and same_stats and same_launches
                  and float(losses["raster_exchange_overflow"]) == 0,
                  f"total {float(losses['total']):.7f} vs {float(ref_losses['total']):.7f} "
                  f"(relative {rel:.2e}, limit 1e-5); worst gradient leaf {mu_err[0]} "
                  f"{mu_err[1]:.3e} of its own max (limit {DP_LEAF_TOL}); worst share of "
                  f"elements moved > half the largest update {worst} {flips[worst]:.4%} (limit "
                  f"0.5%); track_cnt equal {same_stats}; launches "
                  f"{ {k: v for k, v in made.items() if v} } (train_step's the same: "
                  f"{same_launches})")
            del st
        del ref, state0
        root = os.path.join(work, "subject")
        write_subject(root, cli_img, 3, cli_points)
        t0 = time.perf_counter()
        run, _ = counted(lambda: train_cli.main([
            "--subject_root", root, "--device", device, "--mesh", "data=1,tile=1",
            "--gaussian_shard", "--allow_random_lpips", "--epochs", "1", "--repeat", "1",
            "--out_dir", os.path.join(work, "out"), *cli_extra]))
        hist = run.history
        check("apps.train.main --mesh data=1,tile=1 --gaussian_shard",
              len(hist) == 3 and all(math.isfinite(h["total"]) for h in hist)
              and os.path.exists(os.path.join(work, "out", "model_dump", "snapshot_0.npz"))
              and run.settings.gaussian_shard,
              f"{len(hist)} steps in {time.perf_counter() - t0:.1f} s, totals "
              f"{[round(h['total'], 4) for h in hist]}, exchange overflow "
              f"{[h['raster_exchange_overflow'] for h in hist]}, snapshot_0 written")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = par_launches
    log(f"[parallel] launches of the parallel path (sharded renders, steps, CLI): "
        f"{par_launches}")
    if on_card:
        used = ("composite_tiles_fwd_cm", "composite_tiles_bwd_cm", "composite_pairs_fwd_rg",
                "composite_pairs_bwd_rg")
        check("launches", all(par_launches[k] > 0 for k in used)
              and all(v == 0 for k, v in par_launches.items() if k not in used),
              "kernels 1, 2, 7 and 8 launched, no other")
    return res


def start_child_phase(name: str):
    """``chip_smoke.py --phases name`` in a child process on the same card,
    its output to a file: (process, its directory, the start time)."""
    import tempfile

    d = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    with open(os.path.join(d, "log"), "w") as f:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phases", name,
                              "--result", os.path.join(d, "result.json")],
                             stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    log(f"[time] phase {name} started in a child process (pid {p.pid})")
    return name, p, d, time.perf_counter()


def join_child_phase(child, timeout_s: float) -> dict:
    """Waits for a child of ``start_child_phase`` (killed past
    ``timeout_s``), prints its output and returns its phase's result: ok,
    launches and seconds; not ok when it failed or wrote none."""
    import shutil

    name, p, d, t0 = child
    try:
        rc = p.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        rc = None
    with open(os.path.join(d, "log")) as f:
        for line in f:
            print(line, end="")
    path = os.path.join(d, "result.json")
    res = None
    if rc == 0 and os.path.exists(path):
        with open(path) as f:
            res = json.load(f).get(name)
    shutil.rmtree(d, ignore_errors=True)
    if res is None:
        log(f"[{name}] the child process ended with {rc} and no result: FAIL")
        res = {"ok": False, "launches": {k: 0 for k in ALL_KERNELS},
               "seconds": time.perf_counter() - t0}
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
    for k, (regs, smem, st, ld, frame) in pair_resources().items():
        log(f"[build] {k}: {regs} registers, {smem} bytes shared memory, spills {st} B stored / "
            f"{ld} B loaded, {frame} B stack frame")

    # ``--phases a,b`` runs a part (random, goldens, animate, frame, train,
    # probes, convergence, apps, fit, parallel) and
    # prints no result line: the contract needs every phase
    only = None
    if "--phases" in sys.argv[1:]:
        only = set(sys.argv[sys.argv.index("--phases") + 1].split(","))
    # ``--result PATH``: where a child process run by ``start_child_phase``
    # writes its phases' results
    result_path = None
    if "--result" in sys.argv[1:]:
        result_path = sys.argv[sys.argv.index("--result") + 1]
    want = lambda name: only is None or name in only
    ok = True
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] phase {name}: {phase_s[name]:.1f} s")
        return out

    rnd = timed("random", lambda: phase_kernels_random("cuda")) if want("random") else None
    ok &= rnd is None or rnd["ok"]
    ok &= not want("goldens") or timed("goldens", lambda: phase_goldens("cuda"))
    anim = timed("animate", lambda: phase_animate("cuda")) if want("animate") else None
    ok &= anim is None or anim["ok"]
    frm = timed("frame", lambda: phase_frame("cuda")) if want("frame") else None
    ok &= frm is None or frm["ok"]
    trn = timed("train", lambda: phase_train("cuda")) if want("train") else None
    ok &= trn is None or trn["ok"]
    prb = timed("probes", lambda: phase_probes("cuda")) if want("probes") else None
    ok &= prb is None or prb["ok"]
    # the fit phase runs in a child process beside the learning check: both
    # are bound by the host (Python, cv2), neither times a kernel, and the
    # card idles through most of either
    beside = want("fit") and want("convergence") and result_path is None
    fit_child = start_child_phase("fit") if beside else None
    try:
        cnv = (timed("convergence", lambda: phase_convergence("cuda")) if want("convergence")
               else None)
    except BaseException:
        if fit_child is not None:
            fit_child[1].kill()
        raise
    finally:
        fit = join_child_phase(fit_child, 900) if fit_child else None
    ok &= cnv is None or cnv["ok"]
    if fit is not None:
        phase_s["fit"] = fit["seconds"]
        log(f"[time] phase fit (in a child process, beside convergence): {fit['seconds']:.1f} s")
    elif want("fit"):
        fit = timed("fit", lambda: phase_fit("cuda"))
    ok &= fit is None or fit["ok"]
    app = timed("apps", lambda: phase_apps("cuda")) if want("apps") else None
    ok &= app is None or app["ok"]
    par = timed("parallel", lambda: phase_parallel("cuda")) if want("parallel") else None
    ok &= par is None or par["ok"]
    log(f"[time] the whole run: {time.perf_counter() - T_START:.1f} s (phases {phase_s})")
    if result_path is not None:  # a child's phases, for the parent that started it
        ran = {"fit": fit}
        with open(result_path, "w") as f:
            json.dump({k: {"ok": bool(v["ok"]), "launches": v["launches"],
                           "seconds": phase_s[k]} for k, v in ran.items() if v is not None}, f)
    if only is not None:
        log(f"chip_smoke: phases {sorted(only)} {'passed' if ok else 'FAILED'}; a partial run "
            f"prints no result line")
        return 0 if ok else 1

    kernels = []
    pair_res = pair_resources()
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
                   "probes": prb["launches"][name], "convergence": cnv["launches"][name],
                   "apps": app["launches"][name], "fit": fit["launches"][name],
                   "parallel": par["launches"][name]}
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
        if name in pair_res:  # kernels 1-8, from this run's build log
            entry["registers_smem_spills"] = pair_res[name]
        if name == "tile_windows":  # the probe shape above; the binning shape here
            entry.update({k: st[k] for k in ("ms_of", "hot_ms", "host_ms", "floor_ms",
                                              "gather_ms", "wrapper_loop_ms")})
            entry["binning_shape"] = {k: anim["windows"][k] for k in (
                "device_ms", "hot_ms", "in_frame_ms", "host_ms", "floor_ms", "gather_ms",
                "bound_ms", "live")}
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
