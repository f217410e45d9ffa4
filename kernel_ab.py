#!/usr/bin/env python3
"""Time the four compositing kernels of a checkout on one NVIDIA GPU.

    python3 kernel_ab.py [ROOT]

ROOT (default: this file's directory) is a checkout of this repository; its
``chip_smoke.py`` supplies the seeded random windows and its
``exavatar_release_tpu_torch`` the kernels, built from ROOT's sources. Run
it once per checkout inside one call on one card, in the order parent,
change, change, parent, to compare two versions of ``csrc/``. Prints the
card's name and power limit and one JSON line: for each kernel three
CUDA-event means of 30 launches (ms) after 5 warm-up launches, at the 1080p
tiling (510 tiles of 32x128, K = 4096, chunk 256, a random cotangent).
"""
import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
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
    ms = {}
    for name, fn in fns.items():
        cs.cuda_ms(fn, 5)
        ms[name] = [cs.cuda_ms(fn, 30) for _ in range(3)]
    print(cs.card_line())
    print(json.dumps({"root": root, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
