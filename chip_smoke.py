#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (``exavatar_release_tpu_torch``; nothing of JAX or of
the JAX package) and fails with a non-zero exit when any phase fails:

1. builds the CUDA kernels from ``exavatar_release_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the card's name and power limit;
2. holds each compositing kernel against its plain PyTorch version on the
   card, on seeded random windows at the 1080p tiling, and the two kernels
   against each other on the same scene;
3. renders the golden scenes of ``tests/goldens`` through both kernels and
   compares them with the frozen reference outputs;
4. animates a full-width avatar (synthetic SMPL-X at ~10.4k vertices, ~166k
   human Gaussians after 2x subdivision, triplane 32 ch x 128, 1920x1080,
   focal 1200, subject at z = 2.5, tiles 32x128) through
   ``apps.animate.render_motion``, pair-major and dense, with every launch
   counter set to 0 just before and read just after; checks the frames and
   holds both kernels against their plain versions on the frame's own
   inputs; times the frame split into human_forward, projection+binning and
   composite, and each kernel beside its bound and its plain version.

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

KERNEL_SOURCE = "exavatar_release_tpu_torch/csrc/composite.cu"
REPLACES = {
    "composite_tiles_fwd_cm": "exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:666",
    "composite_pairs_fwd_rg": "exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:1389",
}
TOL = {"img": 1e-5, "mask": 1e-5, "depth": 1e-4}  # kernel vs plain, both on the card


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


def profile_frame(fn, top: int = 12) -> dict:
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
    log(f"[profile] one pair-major frame: wall {wall_ms:.3f} ms, device busy "
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
    torch.cuda.synchronize() if device == "cuda" else None
    res = {
        "composite_tiles_fwd_cm": max_err(out1, ref1),
        "composite_pairs_fwd_rg": max_err(out2, ref2),
        "k1_vs_k2": max_err(out1, out2),
        "terminated_pixels": int((ref1[:, 4] > 1 - 1.01e-4).sum()),
        "visits": int(visits.sum()),
    }
    log(f"[kernels/random] T={T} K={K} tile={th}x{tw} visits={res['visits']} "
        f"terminated_pixels={res['terminated_pixels']}")
    for k in ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg", "k1_vs_k2"):
        log(f"[kernels/random] {k} max abs diff {res[k]} (limits {TOL})")
    res["ok"] = all(within(res[k], TOL) for k in
                    ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg", "k1_vs_k2"))
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

    paths = sorted(glob.glob(os.path.join(REPO, "tests", "goldens", "scene*.npz")))
    ok = bool(paths)
    for p in paths:
        d = dict(np.load(p))
        H, W = int(d["H"]), int(d["W"])
        f = float(d["focal"])
        cam = Camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                     torch.tensor([f, f], device=device),
                     torch.tensor([W / 2.0, H / 2.0], device=device))
        args = [torch.from_numpy(d[k]).to(device)
                for k in ("means3d", "scales", "quats", "opacities", "rgbs", "live")]
        for pm in (False, True):
            s = RasterizeSettings(tile_h=8, tile_w=128, max_per_tile=64, chunk=32, pair_major=pm)
            o = rasterize(*args, cam, (H, W), torch.from_numpy(d["bg"]).to(device), s)
            err = {k: float(np.abs(o[k].cpu().numpy() - d[k]).max())
                   for k in ("img", "mask", "depth", "radius")}
            # the goldens were captured on a CPU; exp/log round differently here
            good = within(err, {"img": 5e-5, "mask": 5e-5, "depth": 1e-4, "radius": 0.0})
            ok &= good
            log(f"[goldens] {os.path.basename(p)} pair_major={pm} max abs diff {err} "
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


def phase_animate(device, img=(1080, 1920), focal=1200.0, dense_k=16384, timing_iters=3,
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
    kn.composite_tiles_fwd_cm.launches = 0
    kn.composite_pairs_fwd_rg.launches = 0
    fr = render_motion(human, buffers, prior, id_info, poses, cams, cfg, ragged, (H, W))
    fd = render_motion(human, buffers, prior, id_info, poses, cams, cfg, dense, (H, W))
    sync()
    launches = {"composite_tiles_fwd_cm": kn.composite_tiles_fwd_cm.launches,
                "composite_pairs_fwd_rg": kn.composite_pairs_fwd_rg.launches}
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
    for k, v in launches.items():
        check(f"{k} launched", v > 0, f"{v} launches")

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
    for line in cuda_build.build_log("composite").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    ok = True
    rnd = phase_kernels_random("cuda")
    ok &= rnd["ok"]
    ok &= phase_goldens("cuda")
    anim = phase_animate("cuda")
    ok &= anim["ok"]

    kernels = []
    for name in ("composite_tiles_fwd_cm", "composite_pairs_fwd_rg"):
        st = anim["kernel_stats"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": anim["launches"][name],
            "max_abs_err": max(st["max_abs_err"], max(rnd[name].values())),
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            # no single PyTorch call composites Gaussians
            "library_ms": None,
        })
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
