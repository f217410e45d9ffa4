"""Animate traffic: one viewer in a closed loop over a seeded motion,
cycled. A frame is the program's ``apps.animate.render_motion`` of one pose
with the traffic's rasterizer settings, its image quantized to uint8 (clip,
x255, truncate: what the CLI's PNG writer does) and copied to the host.

After the window a sample of the finished frames, drawn from the seed, is
rendered again by the reference, quantized the same way, and compared.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

import harness
from build import PROGRAM, REFERENCE, build_avatar, camera, posed
from inputs import make_inputs


def quantize(img: torch.Tensor) -> torch.Tensor:
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def reference_frame(side, inp, i: int, img_shape):
    """The reference's frame of pose ``i``: human_forward, then one render
    of the refined Gaussians over a white background."""
    human_mod = importlib.import_module(f"{REFERENCE}.avatar.human")
    api = importlib.import_module(f"{REFERENCE}.ops.rasterizer.api")
    prior, cfg, human, buffers, id_info = side
    cam = camera(REFERENCE, inp)
    with torch.no_grad():
        h = human_mod.human_forward(human, buffers, prior, posed(REFERENCE, inp, i), id_info,
                                    cam.R, cam.t, cfg)
        a = h.assets_refined
        out = api.rasterize(a.mean_3d, a.scale, a.rotation, a.opacity, a.rgb, a.live, cam,
                            img_shape, torch.ones(3, device=a.mean_3d.device))
    return quantize(out["img"]).cpu()


def flip_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of the image's uint8 values that differ."""
    return float((got != want).float().mean())


def run(env) -> dict:
    tr = env.traffic
    H, W = env.cfg["image"]
    inp = make_inputs(env.cfg, env.seed, env.device, "animate")
    env.log("inputs made")
    prior, cfg, human, buffers, id_info = build_avatar(PROGRAM, inp, env.device)
    env.log("program built")
    anim = importlib.import_module(f"{PROGRAM}.apps.animate")
    api = importlib.import_module(f"{PROGRAM}.ops.rasterizer.api")
    settings = api.RasterizeSettings(**tr["settings"])
    cam = camera(PROGRAM, inp)
    n_poses = inp.poses["trans"].shape[0]
    poses = [posed(PROGRAM, inp, i) for i in range(n_poses)]

    def frame(i: int):
        out = anim.render_motion(human, buffers, prior, id_info, [poses[i]], [cam], cfg, settings,
                                 (H, W))[0]
        flags = torch.stack([torch.isfinite(out["img"]).all().float(),
                             out["n_dropped_pairs"].float(), out["n_truncated"].float()])
        img = quantize(out["img"]).cpu()
        f = flags.tolist()
        return img, f[0] == 1.0 and f[1] == 0 and f[2] == 0

    for i in range(tr["warmup_frames"]):
        frame(i % n_poses)
    env.mark_setup()

    done = {}  # pose index -> uint8 image of its first finished frame
    res = {"attempted": 0, "failed": 0}
    nxt = [tr["warmup_frames"]]

    def one():
        i = nxt[0] % n_poses
        nxt[0] += 1
        res["attempted"] += 1
        img, ok = frame(i)
        res["failed"] += not ok
        done.setdefault(i, img)

    if env.trace:
        kernels = importlib.import_module(f"{PROGRAM}.ops.rasterizer.kernels")
        for k in kernels.KERNELS:
            k.launches = 0
        env.reset_peak()

        def units():
            for _ in range(tr["trace_units"]):
                one()
            return tr["trace_units"]

        spans = [(api, "prepare", harness.SPANS["prepare"]),
                 (anim, "human_forward", harness.SPANS["human_forward"])]
        with harness.Spans(spans):
            n, window_s, trace = env.traced(units)
        res["launch_counters"] = {k.__name__: k.launches / n for k in kernels.KERNELS}
        res.update(trace=trace, units=n, unit_s=window_s / n)
    else:
        env.reset_peak()
        lat = []
        t0 = time.perf_counter()
        deadline = t0 + env.seconds
        while time.perf_counter() < deadline:
            a = time.perf_counter()
            one()
            lat.append(time.perf_counter() - a)
        elapsed = time.perf_counter() - t0
        res["end_to_end"] = {"frame_ms": 1e3 * elapsed / res["attempted"],
                             "frame_ms_p95": 1e3 * harness.quantile(lat, 0.95)}
    res["peak"] = env.peak()
    env.log(f"window closed: {res['attempted']} frames")
    del human, buffers, prior, poses
    harness.free_device()

    # the reference on a sample of the finished frames, drawn from the seed
    from torch.utils.flop_counter import FlopCounterMode

    from counts.composite import COUNTS, work_per_unit

    rng = np.random.default_rng(int(env.seed) & ((1 << 63) - 1))
    finished = sorted(done)
    sample = sorted(rng.choice(finished, size=min(tr["compare_frames"], len(finished)),
                               replace=False).tolist())
    side = build_avatar(REFERENCE, inp, env.device)
    worst = 0.0
    COUNTS.reset()
    COUNTS.on = env.trace
    flops = FlopCounterMode(display=False)
    try:
        for j, i in enumerate(sample):
            if env.trace and j == 0:
                with flops:
                    want = reference_frame(side, inp, i, (H, W))
            else:
                want = reference_frame(side, inp, i, (H, W))
            worst = max(worst, flip_share(done[i], want))
    finally:
        COUNTS.on = False
    if env.trace:
        res["flops_first_step"] = flops.get_total_flops()
        res["work"] = work_per_unit(COUNTS, len(sample))
    env.log(f"compared frames {sample}: worst share of differing uint8 values {worst!r}")
    env.checks.add("level_flips", worst, tr["limits"]["level_flips"])
    return res
