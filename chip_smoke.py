#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (``exavatar_release_tpu_torch``; nothing of JAX or of
the JAX package) and fails with a non-zero exit when any phase fails:

1. builds the CUDA kernels from ``exavatar_release_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the card's name and power limit;
2. holds each compositing kernel, forward and backward, against its plain
   PyTorch version on the card, on seeded random windows at the 1080p
   tiling (a random cotangent for the backward; each of its ten used rows
   against that row's own largest value), and the two forward kernels
   against each other on the same scene;
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
   memory and a profile.

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

FWD_KERNELS = ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg")
BWD_KERNELS = ("composite_tiles_bwd_cm", "composite_pairs_bwd_rg")
KERNEL_SOURCE = {k: "exavatar_release_tpu_torch/csrc/composite.cu" for k in FWD_KERNELS}
KERNEL_SOURCE.update({k: "exavatar_release_tpu_torch/csrc/composite_bwd.cu" for k in BWD_KERNELS})
_PK = "exavatar_release_tpu/ops/rasterizer/pallas_kernels.py"
REPLACES = {
    "composite_tiles_fwd_cm": f"{_PK}:666",
    "composite_tiles_bwd_cm": f"{_PK}:716",
    "composite_pairs_fwd_rg": f"{_PK}:1389",
    "composite_pairs_bwd_rg": f"{_PK}:1445",
}
TOL = {"img": 1e-5, "mask": 1e-5, "depth": 1e-4}  # kernel vs plain, both on the card
# backward kernel vs plain, each of the ten used rows against that row's own
# largest |plain| value (the rows differ in unit by orders of magnitude): the
# kernels sum over pixels with atomics, in an order that differs from the
# plain version's
GRAD_TOL = 1e-4
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

    for k in FWD_KERNELS + BWD_KERNELS:
        getattr(kn, k).launches = 0


def read_launches() -> dict:
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    return {k: getattr(kn, k).launches for k in FWD_KERNELS + BWD_KERNELS}


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
    res["ok"] = zeros_ok and all(within(res[k], TOL) for k in
                                 ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg", "k1_vs_k2"))
    res["ok"] &= all(res[k]["ok"] for k in BWD_KERNELS)
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
    for k in BWD_KERNELS:  # serving runs under no_grad: no backward, nothing saved
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
    import numpy as np
    import torch

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
    fv = prior.face_vertex_idx.cpu().numpy()
    faces = a.faces.cpu().numpy()
    inv = -np.ones(a.num_vertices, np.int64)
    inv[fv] = np.arange(fv.size)
    face_faces = inv[faces[(inv[faces] >= 0).all(axis=1)]]
    if face_faces.size == 0:
        face_faces = np.zeros((1, 3), np.int64)
    pts = a.v_template.cpu().numpy()[fv]
    lo, hi = pts.min(0), pts.max(0)
    uv = ((pts[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)).astype(np.float32)
    statics = build_statics(prior, buffers, face_faces, uv, face_faces)

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

    # capacities: the pair budget and the dense window width at which this
    # frame's largest render (scene + human) loses no pair
    with torch.no_grad():
        cam = frame.cam
        s_asset = sc.scene_assets(sc.SceneState(trainables.scene, scene_aux), cam.R, cam.t)
        h_asset = human_forward(trainables.human, bundle.buffers, bundle.prior,
                                trainables.frames.lookup(0), bundle.id_info, cam.R, cam.t,
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
    log(f"[frame] capacities: pairs_per_gaussian={ppg}, dense max_per_tile={dense_k} "
        f"(largest tile holds {max_count}; scene+human render has {pairs} live pairs)")
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
        want = {k: want.get(k, 0) if on_card else 0 for k in FWD_KERNELS + BWD_KERNELS}
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

    ok = True
    rnd = phase_kernels_random("cuda")
    ok &= rnd["ok"]
    ok &= phase_goldens("cuda")
    anim = phase_animate("cuda")
    ok &= anim["ok"]
    frm = phase_frame("cuda")
    ok &= frm["ok"]

    kernels = []
    for name in FWD_KERNELS + BWD_KERNELS:
        fwd = name in FWD_KERNELS
        # forward kernels: measured on the animate frame's windows; backward
        # kernels: on the train-mode frame's scene+human render
        st = (anim if fwd else frm)["kernel_stats"][name]
        by_path = {"animate": anim["launches"][name],
                   **{f"frame_{k}": v[name] for k, v in frm["launches"].items()}}
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # the largest difference from the plain version, random windows included
            "max_abs_err": max(st["max_abs_err"],
                               max(rnd[name].values()) if fwd else rnd[name]["max_abs_err"]),
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            # no single PyTorch call composites Gaussians or differentiates that
            "library_ms": None,
        }
        if not fwd:  # the figure the backward kernels are held to (GRAD_TOL)
            entry["max_row_rel_err"] = max(st["max_row_rel_err"], rnd[name]["max_row_rel_err"])
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
