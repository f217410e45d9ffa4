"""Probe: per-tile window build as a CUDA kernel (csrc/windows.cu) against
the binning's own gather (counterpart of tools/win_probe.py of the JAX
repository, whose kernel is a dynamic-offset DMA per tile).

out[t, k] = rank[starts[t] + k] for k below the tile's count, else the
sentinel n. The binnings build their windows with ``binning._windows``, one
PyTorch indexing call; that gather is the yardstick here.

    python -m exavatar_release_tpu_torch.tools.win_probe [--iters 10] [--device cuda]

Seeded as the JAX tool: T = 2040 tiles, K = 1024, Pm = 1.6M pairs, n = 100k
Gaussians. Prints the parity (integer for integer) and the mean ms of each
call (CUDA events around a loop of calls on the card, the host clock on the
CPU): a loop of the wrapper measures its host time, several times the
kernel's; ``kernel_ab.windows_times`` measures the kernel alone.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.rasterizer import kernels as kn
from .kvariants import time_ms

N, T, K, PM = 100_000, 2040, 1024, 1_600_000


def seeded_inputs(device, seed: int = 0):
    """(starts (T+1,) i32, rank_pad (Pm+1,) i32 with the sentinel n last)."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, PM, (T + 1,)).astype(np.int32))
    starts[0], starts[-1] = 0, PM
    rank = rng.integers(0, N, (PM,)).astype(np.int32)
    rank_pad = np.concatenate([rank, np.full((1,), N, np.int32)])
    return torch.from_numpy(starts).to(device), torch.from_numpy(rank_pad).to(device)


def run_probe(starts, rank_pad, K: int, n: int, iters: int,
              log: Optional[Callable[[str], None]] = print) -> Dict[str, object]:
    """Parity of the kernel with the gather and the time of each."""
    dev = starts.device
    ref = kn.tile_windows_plain(starts, rank_pad, K, n)
    out = kn.tile_windows(starts, rank_pad, K, n)
    match = bool(torch.equal(out, ref))
    log(f"parity: {match}")
    res = {"parity": match, "ms": {}}
    for name, f in (("gather", kn.tile_windows_plain), ("kernel", kn.tile_windows)):
        res["ms"][name] = time_ms(lambda: f(starts, rank_pad, K, n), iters, dev)
        log(f"windows {name}: {res['ms'][name]:8.4f} ms")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    starts, rank_pad = seeded_inputs(torch.device(args.device))
    ok = run_probe(starts, rank_pad, K, N, args.iters)["parity"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
