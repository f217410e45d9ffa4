"""Realistic-shape check of the two sharded renders (counterpart of
exavatar_release_tpu/tools/multichip_scale.py): the tile-sharded render and
the Gaussian-sharded render with its exchange, at ~100k Gaussians and
512x896, against the single-device render through the same kernels: loss
and gradients, one Adam update from each, and the communication volumes
per rank and step.

    python -m exavatar_release_tpu_torch.tools.multichip_scale --devices 4
        [--n 100000] [--h 512] [--w 896] [--device cuda|cpu]

It runs over a local mesh (``parallel.make_mesh``) of ``--devices`` ranks:
the visible cards when there are that many, else that many repeats of
``--device`` (four bands on one card). Without a card it raises unless
``--device cpu`` is given. The JAX tool runs its two renders in context on
a device mesh; here they are the standalone renders over the local mesh,
and the report keeps the JAX tool's keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..core.camera import Camera
from ..ops.rasterizer.api import RasterizeSettings, rasterize
from ..parallel.sharded_raster import (
    PAYLOAD_COLS,
    rasterize_gaussian_sharded,
    rasterize_sharded,
    resolve_exchange_cap,
)
from ..train.optim import adam_step_

NAMES = ("means", "scales", "opac", "rgbs")


def build_scene(n: int, H: int, W: int, seed: int = 0, device="cpu") -> Dict:
    """Dense random scene (n splats filling the frustum, 5-20 mm scales at
    2-6 m depth), drawn with numpy as the JAX tool draws it."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32)
    focal = 500.0 * (H / 512.0)
    x = rng.uniform(-0.5, 0.5, (n, 1)).astype(np.float32) * (W / focal) * z
    y = rng.uniform(-0.5, 0.5, (n, 1)).astype(np.float32) * (H / focal) * z
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return dict(
        means=t(np.concatenate([x, y, z], 1)),
        scales=t(np.exp(rng.uniform(np.log(0.005), np.log(0.02), (n, 3)))),
        quats=t(quats),
        opac=t(rng.uniform(0.3, 0.9, (n, 1))),
        rgbs=t(rng.uniform(0, 1, (n, 3))),
        live=torch.ones(n, dtype=torch.bool, device=device),
        cam=Camera(R=t(np.eye(3)), t=t(np.zeros(3)), focal=t([focal, focal]),
                   princpt=t([W / 2.0, H / 2.0])),
        bg=t(np.zeros(3)),
    )


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_sharded_scale(mesh, n: int = 100_000, H: int = 512, W: int = 896, axis: str = "tile",
                        settings: RasterizeSettings = RasterizeSettings(max_per_tile=512),
                        max_rms: float = 0.05, mean_rms: float = 1e-3,
                        update_flip_frac: float = 0.005,
                        log: Callable[[str], None] = print) -> Dict[str, float]:
    """Single-device, tile-sharded and Gaussian-sharded forward and backward
    on the SAME scene on the mesh's first device; asserts loss and gradient
    parity and one Adam update's parity, and reports times and the analytic
    communication volumes. Returns the report."""
    D = mesh.shape[axis]
    device = mesh.axis_devices(axis)[0]
    sc = build_scene(n, H, W, device=device)

    # size the per-tile capacity so that NOTHING truncates: with truncation
    # the single-device compact binning and the band's sorted binning crop
    # different (tied-depth) pairs, so parity is defined at zero drops only,
    # which is also training's steady state under the capacity governor
    with torch.no_grad():
        probe = rasterize(sc["means"], sc["scales"], sc["quats"], sc["opac"], sc["rgbs"],
                          sc["live"], sc["cam"], (H, W), sc["bg"], settings)
    kmax = int(probe["tile_counts"].max())
    K = -(-(kmax + 64) // 128) * 128
    settings = dataclasses.replace(settings, max_per_tile=K)
    log(f"[multichip_scale] per-tile capacity auto-sized to {K} (max occupancy {kmax})")

    def loss_from(r):
        return torch.sum(r["img"] ** 2) + torch.sum(r["mask"]) + torch.sum(r["depth"])

    def value_and_grads(render):
        def fn():
            xs = [sc[k].detach().clone().requires_grad_(True) for k in NAMES]
            means, scales, opac, rgbs = xs
            loss = loss_from(render(means, scales, sc["quats"], opac, rgbs, sc["live"],
                                    sc["cam"], (H, W), sc["bg"]))
            grads = torch.autograd.grad(loss, xs)
            return loss.detach(), grads
        return fn

    def timed(fn, label):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        dt = time.perf_counter() - t0
        log(f"[multichip_scale] {label}: {dt * 1e3:.1f} ms/step (first call {t_first:.2f} s) "
            f"at {H}x{W}/{n}g on {D} bands of {mesh.axis_devices(axis)}")
        return out, dt

    single = lambda *a: rasterize(*a, settings)
    (v_ref, g_ref), t_single = timed(value_and_grads(single), "single")
    report = {"n": n, "H": H, "W": W, "devices": D, "t_single_s": t_single}
    renders = {
        "tile_in_context": lambda *a: rasterize_sharded(*a, mesh, axis, settings),
        "gaussian_sharded": lambda *a: rasterize_gaussian_sharded(*a, mesh, axis, settings),
    }
    g_by_label = {}
    for label, render in renders.items():
        (v, g), dt = timed(value_and_grads(render), label)
        np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
        for name, a, b in zip(NAMES, g, g_ref):
            # the failures this guards (dropped pairs, misrouted exchange
            # cotangents, a wrong gradient sum) give O(1)·rms errors on whole
            # slices; the bounds leave room for float32 sums in another order
            a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
            rms = float(np.sqrt(np.mean(b * b))) + 1e-12
            d = np.abs(a - b)
            assert d.max() <= max_rms * rms + 1e-6, (label, name, d.max(), rms)
            assert d.mean() <= mean_rms * rms + 1e-8, (label, name, d.mean(), rms)
        report[f"t_{label}_s"] = dt
        g_by_label[label] = g
        log(f"[multichip_scale] {label}: loss+grad parity OK (max<={max_rms}·rms, "
            f"mean<={mean_rms}·rms)")

    # one fresh Adam update (optax.scale_by_adam's arithmetic) from the
    # single-device and from the Gaussian-sharded gradients: the difference
    # is at most 2·lr by construction; the share of elements moved by more
    # than lr/2 counts near-zero gradients whose sign flipped under another
    # summation order, where routing faults flip whole slices
    lr = 1e-3

    def one_update(grads):
        params = [sc[k].detach().clone() for k in NAMES]
        before = [p.clone() for p in params]
        adam_step_(params, list(grads), [torch.zeros_like(p) for p in params],
                   [torch.zeros_like(p) for p in params], 1, [lr] * len(params), 0.9, 0.999,
                   1e-8)
        return [p - q for p, q in zip(params, before)]

    upd_ref = one_update(g_ref)
    upd_sh = one_update(g_by_label["gaussian_sharded"])
    worst_flip = 0.0
    for name, a, b in zip(NAMES, upd_sh, upd_ref):
        d = (a - b).abs().cpu().numpy()
        flip_frac = float((d > 0.5 * lr).mean())
        worst_flip = max(worst_flip, flip_frac)
        assert d.max() <= 2.0 * lr * 1.001, (name, d.max())
        assert flip_frac <= update_flip_frac, (
            f"{name}: {flip_frac:.4%} of elements moved > lr/2 between sharded and "
            f"single-device Adam updates (bound {update_flip_frac:.2%})")
        report[f"update_flip_frac_{name}"] = flip_frac
    log(f"[multichip_scale] optimizer-update parity OK: worst sign-flip fraction "
        f"{worst_flip:.4%} (bound {update_flip_frac:.2%}, max |Δupdate| <= 2·lr)")

    # analytic communication per rank and step (forward + backward)
    th = settings.tile_h
    Hp = -(-H // (th * D)) * (th * D)
    band_bytes = Hp * W * 5 * 4  # all_gather forward, reduce-scatter backward
    exch_bytes = D * resolve_exchange_cap(n, D) * PAYLOAD_COLS * 4  # all_to_all each way
    grad_psum_bytes = n * (3 + 3 + 1 + 3) * 4  # means, scales, opacity, rgb
    report.update(band_allgather_bytes=band_bytes, exchange_alltoall_bytes=exch_bytes,
                  grad_psum_bytes=grad_psum_bytes)
    log(f"[multichip_scale] comm/rank/step: band all_gather {band_bytes / 1e6:.1f} MB (fwd; "
        f"the same reduce-scattered bwd), gaussian exchange all_to_all "
        f"{exch_bytes / 1e6:.1f} MB each way, param-grad psum {grad_psum_bytes / 1e6:.1f} MB")
    return report


def local_devices(d: int, device: str = "cuda"):
    """D devices for a local mesh: the first D visible cards when there are
    that many, else D repeats of ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
        if torch.cuda.device_count() >= d:
            return [torch.device("cuda", i) for i in range(d)]
    return [dev] * d


def main(argv=None) -> Dict[str, float]:
    from ..parallel import make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--h", type=int, default=512)
    ap.add_argument("--w", type=int, default=896)
    ap.add_argument("--devices", type=int, default=4, help="tile-axis size (row bands)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    mesh = make_mesh((args.devices,), ("tile",), local_devices(args.devices, args.device))
    report = check_sharded_scale(mesh, n=args.n, H=args.h, W=args.w)
    print("[multichip_scale] OK")
    return report


if __name__ == "__main__":
    main()
