#!/usr/bin/env python3
"""Time the eight compositing kernels of a checkout on one NVIDIA GPU.

    python3 kernel_ab.py [ROOT]

ROOT (default: this file's directory) is a checkout of this repository; its
``chip_smoke.py`` supplies the seeded random windows and its
``exavatar_release_tpu_torch`` the kernels, built from ROOT's sources. Run
it once per checkout inside one call on one card, in the order parent,
change, change, parent, to compare two versions of ``csrc/``. Prints the
card's name and power limit and one JSON line: for each kernel three
CUDA-event means of 30 launches (ms) after 5 warm-up launches, at the 1080p
tiling (510 tiles of 32x128, K = 4096, chunk 256, a random cotangent). The
row-major kernels get the same windows repacked (``composite_tiles_fwd_v2`` /
``_bwd_v2`` the packed tile-local coefficients, ``composite_tiles_fwd`` /
``_bwd`` the global rows with origins) and random cotangents of ``accum`` and
``tfinal``. A checkout from before the row-major kernels times the four it has.
The window kernel (``tile_windows``) is timed on seeded inputs at two
shapes: the probe tool's (T = 2,040, K = 1,024, 1.6M sorted pairs) and the
animate frame's dense binning (T = 510, K = 16,384, 280,400 pairs): device
ms per launch from CUDA events around the replay of a CUDA graph of 200
launches, each into the next of preallocated outputs that together exceed
the 50 MB L2 cache twice over (``device_ms``: the output's lines are not in
L2) and all into one output (``hot_ms``: L2-resident, below the bytes bound
at these sizes). Both regimes are reported, and beside them the kernel's
time inside the dense animate frames (``windows_in_frame``: two renders of
ROOT's three poses with the binning's gather replaced by the kernel, read
from torch.profiler), the regime the binning's own windows see. The same of
an empty kernel (the launch floor; in checkouts whose ``windows.cu`` has
one); the wrapper's host ms per call; and the device ms of its plain
version (binning's gather) in a graph of 20 calls.

    python3 kernel_ab.py --binning [ROOT]

times the pair binning of ROOT at the main path's three render sizes (the
human's 164,379 Gaussians, and with the 32,768 or 131,072 Gaussians of the
two scenes' capacities; a budget of 16 pairs each, rounded up to the chunk
of 256) on seeded screen-space inputs at 1080x1920 in tiles of 32x128
(radii 1-80 px, a tenth culled): ``bin_gaussians_ragged`` whole
(``ragged_ms``, CUDA events around 10 calls, the least of three), and each
of its two kernels, ``expand_pairs`` and ``chunk_slots``, on that call's own
inputs (``binning_kernel_times``: the kernel and its plain version, each
``graph_ms``, both outputs bit for bit, and the bytes bound). Prints the
card's name and power limit and one JSON line.

    python3 kernel_ab.py --sass ROOT_A ROOT_B

compares, kernel by kernel, the SASS (``cuobjdump -sass``, addresses and
encodings dropped) of the default builds of two checkouts (built where
missing) and prints one JSON line: the kernels whose instructions are the
same, those that differ, and those that only one build has; and, in each
build that has the stage probes' kernels, whether the ``base`` variant's
instructions are those of the kernel it probes (``base_is_product``).
"""
import json
import math
import os
import re
import subprocess
import sys


def _sass(lib: str) -> dict:
    """{kernel: [instructions]} of a built library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # an anonymous namespace's name carries hashes of its translation unit
            name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "_ZN_anon_",
                          m.group(1))
            cur = out.setdefault(name, [])
            continue
        ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
        if cur is not None and ins and not ins.startswith(".") and ins != "}":
            cur.append(ins)
    return out


def compare_sass(root_a: str, root_b: str) -> dict:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from exavatar_release_tpu_torch import cuda_build as b; "
            "print(json.dumps(b.build()))")
    libs = [json.loads(subprocess.run([sys.executable, "-c", code, r], capture_output=True,
                                      text=True, check=True).stdout) for r in (root_a, root_b)]
    res = {"same": [], "differ": [], "only_one": [], "base_is_product": {}}
    for name in sorted(set(libs[0]) | set(libs[1])):
        a, b = (_sass(lib[name]) if name in lib else {} for lib in libs)
        for fn in sorted(set(a) | set(b)):
            key = "only_one" if (fn in a) != (fn in b) else ("same" if a[fn] == b[fn]
                                                               else "differ")
            res[key].append(f"{name}:{fn}")
        for side, sass in (("a", a), ("b", b)):
            for d in ("fwd", "bwd"):
                probe = f"composite_tiles_{d}_variant_kernelILi0E"
                base = [v for k, v in sass.items() if probe in k]
                prod = [v for k, v in sass.items() if f"composite_tiles_{d}_kernelE" in k]
                if base and prod:
                    res["base_is_product"][f"{side}:{d}"] = base[0] == prod[0]
    return res


def graph_ms(launch, iters: int = 200, reps: int = 3) -> float:
    """Device ms per launch: CUDA events around the replay of a CUDA graph
    of ``iters`` calls of ``launch(stream)``, the least of ``reps`` replays.
    The graph leaves out the host: what is left is the kernels and the gaps
    between graph nodes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(iters):
            launch(stream)
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def window_inputs(T: int, Pm: int, n: int, seed: int, device="cuda"):
    """Seeded (starts (T + 1,) i32 from 0 to Pm, rank (Pm,) i32 below n), as
    tools/win_probe.py makes its inputs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, Pm, (T + 1,)).astype(np.int32))
    starts[0], starts[-1] = 0, Pm
    rank = rng.integers(0, n, (Pm,)).astype(np.int32)
    return torch.from_numpy(starts).to(device), torch.from_numpy(rank).to(device)


# (T, K, sorted pairs, Gaussians) of the probe tool and of the animate
# frame's dense binning (chip_smoke.py phase_animate: 164,379 human Gaussians)
WINDOW_SHAPES = {"probe": (2040, 1024, 1_600_000, 100_000),
                 "binning": (510, 16384, 280_400, 164_379)}


L2_BYTES = 50e6  # H100


def windows_times(kn, starts, rank, K: int, n: int, iters: int = 200) -> dict:
    """device_ms (outputs cycled past twice the L2), hot_ms (one output) and
    floor_ms per launch (``graph_ms``; floor_ms None where the library has no
    empty kernel), gather_ms per call of the plain version (``graph_ms``),
    host_ms per call of the wrapper (host clock over ``iters`` calls, then one
    synchronize) and the bytes bound."""
    import ctypes
    import time

    import torch

    lib = kn._lib_windows()
    T = starts.shape[0] - 1
    outs = [torch.empty(T, K, dtype=torch.int32, device=starts.device)
            for _ in range(max(2, math.ceil(2 * L2_BYTES / (4 * T * K))))]
    turn = [0]

    def launch(stream, cycle=True):
        out = outs[turn[0] % len(outs)] if cycle else outs[0]
        turn[0] += 1
        if lib.tile_windows(starts.data_ptr(), rank.data_ptr(), out.data_ptr(), T, K, n,
                            stream) != 0:
            raise RuntimeError("tile_windows launch failed")

    res = {"device_ms": graph_ms(launch, iters),
           "hot_ms": graph_ms(lambda stream: launch(stream, cycle=False), iters),
           "floor_ms": None, "outputs_cycled": len(outs)}
    del outs[1:]
    # the plain version (binning's gather, a few PyTorch calls) captured the
    # same way, on the graph's current stream
    res["gather_ms"] = graph_ms(lambda stream: kn.tile_windows_plain(starts, rank, K, n), 20)
    if hasattr(lib, "launch_floor"):
        lib.launch_floor.argtypes = [ctypes.c_void_p]
        res["floor_ms"] = graph_ms(lambda stream: lib.launch_floor(stream), iters)
    kn.tile_windows(starts, rank, K, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        kn.tile_windows(starts, rank, K, n)
    res["host_ms"] = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    live = int(torch.clamp(starts[1:].long() - starts[:-1].long(), max=K).sum())
    res["bound_ms"] = 1e3 * 4 * (live + T * K + T + 1) / 3.35e12
    res["live"] = live
    return res


def windows_in_frame(render_frame) -> list:
    """Kernel 11's device time (us) per launch inside a dense frame, where
    the binning's windows are built: ``render_frame()`` runs under
    torch.profiler with ``binning._windows`` replaced, for this measurement
    only, by the kernel (the gather's int64 inputs cast to int32), so its
    output is allocated and written where the gather's would be; whether it
    then reads as the L2-resident or the cycled time of ``windows_times``
    says which regime the frame's windows see."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    def kernel_windows(rank_sorted, starts, counts, n, max_per_tile):
        return kn.tile_windows(starts.int(), rank_sorted.int(), max_per_tile, n)

    plain = bnm._windows
    torch.cuda.synchronize()
    try:
        bnm._windows = kernel_windows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render_frame()
            torch.cuda.synchronize()
    finally:
        bnm._windows = plain
    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and "tile_windows_kernel" in e.name]


def animate_frames(cs, reps: int = 2):
    """A call that renders the animate frame's poses densely ``reps`` times,
    as ``chip_smoke.phase_animate`` does (ROOT's ``build_avatar``, 1920x1080,
    focal 1200, K = 16,384: the binning shape), after one warm-up call."""
    import torch

    from exavatar_release_tpu_torch.apps.animate import render_motion
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer import api

    prior, cfg, human, buffers, id_info, poses = cs.build_avatar("cuda")
    H, W, f = 1080, 1920, 1200.0
    cam = Camera(torch.eye(3, device="cuda"), torch.zeros(3, device="cuda"),
                 torch.tensor([f, f], device="cuda"), torch.tensor([W / 2.0, H / 2.0], device="cuda"))
    dense = api.RasterizeSettings(max_per_tile=WINDOW_SHAPES["binning"][1])

    def run():
        for _ in range(reps):
            render_motion(human, buffers, prior, id_info, poses, [cam] * len(poses), cfg, dense,
                          (H, W))

    run()
    return run


# Gaussians a render at the main path's pair budgets (Pm 2.63M, 3.15M, 4.73M)
BINNING_SHAPES = {"human": 164_379, "human_s20k": 197_147, "human_s131k": 295_451}


def binning_inputs(n: int, seed: int, device="cuda"):
    """Seeded screen-space (mean2d, radius, depth, visible, extent) at
    1080x1920: means over and around the image, radii 1-80 px."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    radius = np.ceil(np.exp(rng.uniform(np.log(1.0), np.log(80.0), n)))
    arrays = (rng.uniform([-50.0, -50.0], [1970.0, 1130.0], (n, 2)), radius,
              rng.uniform(0.5, 9.0, n), rng.uniform(size=n) > 0.1,
              radius[:, None] * rng.uniform(0.3, 1.0, (n, 2)))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.bool if a.dtype == bool
                                                         else torch.float32) for a in arrays]


def binning_kernel_times(kn, name: str, args) -> dict:
    """``name`` (``expand_pairs`` or ``chunk_slots``) on the inputs ``args``
    a binning gave it: ``ms``, the kernel alone through its C entry
    (``graph_ms``), ``plain_ms``, its plain version (``graph_ms`` of 20),
    ``equal``, both outputs bit for bit, and ``bound_ms`` by bytes: 16 B a
    slot written and 40 B a Gaussian read (``expand_pairs``), 8 B a chunk
    slot written and 8 B a bound read (``chunk_slots``)."""
    import torch

    lib = kn._lib_binning()
    plain = getattr(kn, f"{name}_plain")
    if name == "expand_pairs":
        offsets, span, x_lo, y_lo, w, nx, num_tiles, Pm = args
        n = offsets.shape[0]
        outs = [torch.empty(Pm, dtype=torch.int64, device="cuda") for _ in range(2)]
        ptrs = [x.data_ptr() for x in (offsets, span, x_lo, y_lo, w, *outs)]
        entry = lambda stream: lib.expand_pairs(*ptrs, n, Pm, nx, num_tiles, stream)
        res = {"n": n, "Pm": Pm, "bound_ms": 1e3 * (16 * Pm + 40 * n) / 3.35e12}
    else:
        bounds, NC = args
        T = bounds.shape[0] - 1
        outs = [torch.empty(NC, dtype=torch.int32, device="cuda") for _ in range(2)]
        entry = lambda stream: lib.chunk_slots(bounds.data_ptr(), outs[0].data_ptr(),
                                               outs[1].data_ptr(), T, NC, stream)
        res = {"T": T, "NC": NC, "bound_ms": 1e3 * (8 * NC + 8 * (T + 1)) / 3.35e12}

    def launch(stream):
        if entry(stream) != 0:
            raise RuntimeError(f"{name} launch failed")

    res["ms"] = graph_ms(launch)
    res["plain_ms"] = graph_ms(lambda stream: plain(*args), 20)
    res["equal"] = all(torch.equal(a, b) for a, b in zip(outs, plain(*args)))
    res["bound_by"] = "bytes"
    return res


def binning_times(n: int) -> dict:
    import torch

    import chip_smoke as cs
    from exavatar_release_tpu_torch.ops.rasterizer import binning as bnm
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    img, tile, chunk = (1080, 1920), (32, 128), 256
    m2d, rad, depth, vis, ext = binning_inputs(n, seed=n)
    run = lambda: bnm.bin_gaussians_ragged(m2d, rad, depth, vis, img, *tile, chunk=chunk,
                                           max_pairs=16 * n, extent=ext)
    calls = {}
    with cs.checked_binning(calls):  # the kernels' inputs, as the binning makes them
        run()
    run()
    torch.cuda.synchronize()
    res = {"n": n, "ragged_ms": min(cs.cuda_ms(run, 10) for _ in range(3))}
    for name, launches in calls.items():
        args, err = launches[0]
        res[name] = {"max_abs_err": err, **binning_kernel_times(kn, name, args)}
    res["pairs"] = int(calls["expand_pairs"][0][0][1].sum())
    return res


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        print(json.dumps(compare_sass(os.path.abspath(args[1]), os.path.abspath(args[2]))))
        return 0
    if args[:1] == ["--binning"]:
        root = os.path.abspath(args[1] if len(args) > 1 else os.path.dirname(__file__))
        sys.path.insert(0, root)
        import chip_smoke as cs

        res = {k: binning_times(n) for k, n in BINNING_SHAPES.items()}
        print(cs.card_line())
        print(json.dumps({"root": root, "binning": res}))
        return 0
    root = os.path.abspath(args[0] if args else os.path.dirname(__file__))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn

    T, K, tile, nx, chunk = 510, 4096, (32, 128), 15, 256
    win, counts, origins = cs.random_windows(T, K, tile, nx, seed=1, device="cuda")
    bg = torch.tensor([1.0, 0.5, 0.25], device="cuda")
    rows, tid, flags = cs.ragged_from_windows(win, counts, chunk)
    full = kn.composite_tiles_fwd_cm(win, counts, origins, bg, tile)
    g_full = torch.randn(full.shape, generator=torch.Generator().manual_seed(2)).cuda()
    rg = (rows, tid, flags, bg, 0.0)
    fns = {
        "composite_tiles_fwd_cm": lambda: kn.composite_tiles_fwd_cm(win, counts, origins, bg, tile),
        "composite_pairs_fwd_rg": lambda: kn.composite_pairs_fwd_rg(*rg, tile, T, chunk, nx),
        "composite_tiles_bwd_cm": lambda: kn.composite_tiles_bwd_cm(win, counts, origins, bg,
                                                                    full, g_full, tile),
        "composite_pairs_bwd_rg": lambda: kn.composite_pairs_bwd_rg(*rg, full, g_full, tile, T,
                                                                    chunk, nx),
    }
    if hasattr(kn, "composite_tiles_fwd_v2"):
        rows_g, packed, color = cs.rm_rows_from_windows(win, origins)
        f3 = kn.composite_tiles_fwd_v2(packed, color, counts, tile)
        f5 = kn.composite_tiles_fwd(rows_g, color, counts, tile, origins)
        g = torch.Generator().manual_seed(3)
        cot = (torch.randn(f3[0].shape, generator=g).cuda(),
               torch.randn(f3[1].shape, generator=g).cuda())
        fns.update({
            "composite_tiles_fwd_v2": lambda: kn.composite_tiles_fwd_v2(packed, color, counts,
                                                                        tile),
            "composite_tiles_bwd_v2": lambda: kn.composite_tiles_bwd_v2(packed, color, counts,
                                                                        *cot, *f3, tile),
            "composite_tiles_fwd": lambda: kn.composite_tiles_fwd(rows_g, color, counts, tile,
                                                                  origins),
            "composite_tiles_bwd": lambda: kn.composite_tiles_bwd(rows_g, color, counts, *cot,
                                                                  *f5, tile, origins),
        })
    ms = {}
    for name, fn in fns.items():
        cs.cuda_ms(fn, 5)
        ms[name] = [cs.cuda_ms(fn, 30) for _ in range(3)]
    windows = {}
    for shape, (wT, wK, Pm, n) in WINDOW_SHAPES.items():
        starts, rank = window_inputs(wT, Pm, n, seed=0)
        same = torch.equal(kn.tile_windows(starts, rank, wK, n),
                           kn.tile_windows_plain(starts, rank, wK, n))
        windows[shape] = {"equal": same, **windows_times(kn, starts, rank, wK, n)}
    windows["binning"]["in_frame_ms"] = [1e-3 * u for u in windows_in_frame(animate_frames(cs))]
    print(cs.card_line())
    print(json.dumps({"root": root, "ms": ms, "tile_windows": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
