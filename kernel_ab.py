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

    python3 kernel_ab.py --sass ROOT_A ROOT_B

compares, kernel by kernel, the SASS (``cuobjdump -sass``, addresses and
encodings dropped) of the default builds of two checkouts (built where
missing) and prints one JSON line: the kernels whose instructions are the
same, those that differ, and those that only one build has.
"""
import json
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
    res = {"same": [], "differ": [], "only_one": []}
    for name in libs[0]:
        a, b = (_sass(lib[name]) if name in lib else {} for lib in libs)
        for fn in sorted(set(a) | set(b)):
            key = "only_one" if (fn in a) != (fn in b) else ("same" if a[fn] == b[fn]
                                                               else "differ")
            res[key].append(f"{name}:{fn}")
    return res


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        print(json.dumps(compare_sass(os.path.abspath(args[1]), os.path.abspath(args[2]))))
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
    print(cs.card_line())
    print(json.dumps({"root": root, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
