"""Kernel-internals attribution probe: times the pair bodies of the
row-major compositing kernels with origins (kernels 5 and 6) compiled with
one stage stubbed or reformulated, each variant an instantiation of the
bodies' `if constexpr` hooks (counterpart of tools/kvariants.py of the JAX
repository; the variants and their meaning on the pair body are described in
csrc/composite_probes.cuh). base is kernels 5 and 6's own code, launched as a
probe; kernels 5 and 6 themselves ("the product") are timed on the same
scene beside it, and give the reference of every exact variant.

  fwd: base, noexp, nomm, noskip, logsp, pipe, chunk
  bwd: base, noexp, nomm, nograd, fusedgrad, noT, nodeloc, logsp, noT+logsp,
       pipe, chunk

Stubs (noexp, nomm, nograd, nodeloc) give wrong results on purpose; the
exact variants (noskip, logsp, pipe, fusedgrad, noT, noT+logsp, chunk) are
printed with their distance from kernels 5 and 6 ("the product"). The scene
is the JAX tool's: 100k seeded Gaussians at 1088x1920, tiles 32x128, K =
1024, compact binning, a cotangent of ones.

    python -m exavatar_release_tpu_torch.tools.kvariants [--iters 10] [--n 100000]
        [--tile_h 32] [--tile_w 128] [--chunk 256] [--device cuda]

Times are CUDA-event means over ``--iters`` launches after one warm-up; with
``--device cpu`` the plain versions run, timed on the host clock.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..ops.rasterizer import kernels as kn
from ..ops.rasterizer.binning import bin_gaussians_compact, tile_grid
from ..ops.rasterizer.preprocess import project_gaussians

IMG = (1088, 1920)
K = 1024


def build_scene(n: int = 100_000, tile_h: int = 32, tile_w: int = 128, device="cuda",
                seed: int = 0) -> Dict[str, object]:
    """The tool's seeded scene, projected, binned and gathered into (T, K, 8)
    global conic rows and (T, K, 4) colors with tile origins, plus the
    projection and the binning themselves."""
    H, W = IMG
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32)
    focal = 1000.0
    x = rng.uniform(-0.5, 0.5, (n, 1)).astype(np.float32) * (W / focal) * z
    y = rng.uniform(-0.5, 0.5, (n, 1)).astype(np.float32) * (H / focal) * z
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.05), (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cam = Camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                 torch.tensor([focal, focal], device=device),
                 torch.tensor([W / 2.0, H / 2.0], device=device))
    with torch.no_grad():
        p = project_gaussians(t(np.concatenate([x, y, z], 1)), t(scales), t(quats), t(opac),
                              t(rgbs), torch.ones(n, dtype=torch.bool, device=device), cam,
                              (H, W))
        bn = bin_gaussians_compact(p.mean2d, p.radius, p.depth, p.in_frustum, (H, W), tile_h,
                                   tile_w, K, extent=p.extent)
        rows = torch.cat([p.params, p.color], dim=1)
        sentinel = torch.zeros(1, 12, device=device)
        sentinel[0, 5] = -1e9
        tr = torch.cat([rows[bn.order.long()], sentinel])[bn.tile_indices.long()]
    ny, nx = tile_grid((H, W), tile_h, tile_w)
    tid = torch.arange(ny * nx, device=device)
    origins = torch.stack([(tid % nx) * tile_w, (tid // nx) * tile_h], dim=1).float()
    return {"quad": tr[..., :8].contiguous(), "color": tr[..., 8:].contiguous(),
            "counts": bn.tile_counts, "origins": origins, "tile_shape": (tile_h, tile_w),
            "binning": bn, "screen": p, "n": n}


def sub_scene(scene: Dict[str, object], tiles: int) -> Dict[str, object]:
    """The first ``tiles`` tiles of a scene."""
    out = dict(scene)
    for k in ("quad", "color", "counts", "origins"):
        out[k] = scene[k][:tiles].contiguous()
    return out


def fwd(variant: str, s: Dict[str, object], plain: bool = False):
    f = kn.composite_tiles_fwd_variant_plain if plain else kn.composite_tiles_fwd_variant
    return f(variant, s["quad"], s["color"], s["counts"], s["tile_shape"], s["origins"])


def bwd(variant: str, s: Dict[str, object], cot, fwd_out, plain: bool = False):
    """``cot`` = (g_accum, g_tfinal); ``fwd_out`` = base's (accum, tfinal)."""
    f = kn.composite_tiles_bwd_variant_plain if plain else kn.composite_tiles_bwd_variant
    return f(variant, s["quad"], s["color"], s["counts"], *cot, *fwd_out, s["tile_shape"],
             s["origins"])


def time_ms(fn: Callable[[], object], iters: int, device) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def pixels_off(accum, ref, tol: float = 1e-5) -> int:
    """Pixels whose accum differs from ``ref``'s by more than ``tol`` of its
    largest value: where an exact variant's other rounding flipped a
    threshold (1/255, 1e-4) against kernel 5."""
    return int(((accum - ref).abs().amax(-1) > tol * float(ref.abs().max())).sum())


def run_probes(s: Dict[str, object], iters: int, log: Optional[Callable[[str], None]] = print
               ) -> Dict[str, Dict[str, float]]:
    """Kernels 5 and 6 and every variant timed on the scene ``s``, forward
    then backward, each exact variant with its distance from kernels 5 and 6.
    Returns {"fwd": {name: ms}, "bwd": {name: ms}, "err": {"fwd/name": err,
    ...}, "product": {"fwd": ms, "bwd": ms}}."""
    dev = s["quad"].device
    tile = s["tile_shape"]
    args = (s["quad"], s["color"], s["counts"])
    product_f = lambda: kn.composite_tiles_fwd(*args, tile, s["origins"])
    ref_f = product_f()
    res = {"fwd": {}, "bwd": {}, "err": {}, "product": {"fwd": time_ms(product_f, iters, dev)}}
    log(f"fwd/product: {res['product']['fwd']:7.2f} ms  (kernel 5, the pair body)")
    for v in kn.FWD_VARIANTS:
        ms = time_ms(lambda: fwd(v, s), iters, dev)
        res["fwd"][v] = ms
        extra = ""
        if v == "base" or v in kn.EXACT_VARIANTS:
            a, t = fwd(v, s)
            ea, et = max_abs(a, ref_f[0]), max_abs(t, ref_f[1])
            res["err"][f"fwd/{v}"] = max(ea, et)
            extra = (f"  (parity vs product {ea:.2e})" if v == "base"
                     else f"  (acc err {ea:.2e}, tf err {et:.2e}, "
                          f"{pixels_off(a, ref_f[0])} pixels over 1e-5 of the max)")
        log(f"fwd/{v:7s}: {ms:7.2f} ms{extra}")
    cot = (torch.ones_like(ref_f[0]), torch.ones_like(ref_f[1]))
    product_b = lambda: kn.composite_tiles_bwd(*args, *cot, *ref_f, tile, s["origins"])
    ref_b = product_b()
    res["product"]["bwd"] = time_ms(product_b, iters, dev)
    log(f"bwd/product: {res['product']['bwd']:7.2f} ms  (kernel 6, the pair body)")
    for v in kn.BWD_VARIANTS:
        ms = time_ms(lambda: bwd(v, s, cot, ref_f), iters, dev)
        res["bwd"][v] = ms
        extra = ""
        if v == "base" or v in kn.EXACT_VARIANTS:
            dq, dc = bwd(v, s, cot, ref_f)
            e1, e2 = max_abs(dq, ref_b[0]), max_abs(dc, ref_b[1])
            res["err"][f"bwd/{v}"] = max(e1, e2)
            extra = (f"  (parity vs product {e1:.2e})" if v == "base"
                     else f"  (dquad err {e1:.2e}, dcolor err {e2:.2e})")
        log(f"bwd/{v:9s}: {ms:7.2f} ms{extra}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--tile_h", type=int, default=32)
    ap.add_argument("--tile_w", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=kn.PROBE_CHUNK)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.chunk != kn.PROBE_CHUNK:
        raise SystemExit(f"--chunk {args.chunk}: the kernels' chunk is their staging batch of "
                         f"{kn.PROBE_CHUNK} rows, fixed at compile time")
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "plain versions"
    print(f"backend: {dev.type} ({name})")
    run_probes(build_scene(args.n, args.tile_h, args.tile_w, dev), args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
