"""Profiling: ``torch.profiler`` traces and the roofline model of the
compositing forward (counterpart of exavatar_release_tpu/utils/profiling.py).

``trace`` writes a Chrome trace (chrome://tracing, Perfetto) of the host and,
where there is a card, of its kernels; ``composite_roofline`` keeps the JAX
package's analytic model of the Pallas kernel, with the H100's peaks as
defaults; ``StepRater`` is
the JAX package's rolling meter.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

# H100 SXM (NVIDIA data sheet, dense, at the full 700 W power limit): f32
# outside the tensor cores and HBM bandwidth
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_BYTES_PER_S = 3.35e12

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where the card is there) and write ``log_dir/trace.json``, a Chrome
    trace. No-op when ``log_dir`` is None, so that call sites can stay
    unconditional."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def composite_roofline(
    img_shape, tile_h: int, tile_w: int, max_per_tile: int, chunk: int,
    peak_flops: float = H100_PEAK_F32_FLOPS, peak_bw: float = H100_PEAK_BYTES_PER_S,
) -> Dict[str, float]:
    """The JAX package's analytic FLOP/byte model of one tile-compositing
    forward, unchanged: per tile chunk the (P, 8)@(8, G) density matmul, two
    (P, G)@(G, G) triangular prefix matmuls and the (P, G)@(G, 4) color
    matmul; device-memory traffic tile_quad + tile_color in, accum + tfinal
    out. Returns flops, bytes and the compute- and bandwidth-bound times
    against ``peak_flops`` / ``peak_bw`` (default: the H100's).

    The counts describe the Pallas kernel's chunked matmul formulation, not
    the port's CUDA kernels, which blend row by row with no prefix matmuls;
    their bounds (chip_smoke.py, PERF.md) count the visits a run makes."""
    H, W = img_shape
    ny = -(-H // tile_h)
    nx = -(-W // tile_w)
    tiles = ny * nx
    P = tile_h * tile_w
    n_chunks = -(-max_per_tile // chunk)
    per_chunk_flops = 2 * P * 8 * chunk + 2 * 2 * P * chunk * chunk + 2 * P * chunk * 4
    flops = tiles * n_chunks * per_chunk_flops
    bytes_moved = tiles * (max_per_tile * (8 + 4) * 4 + P * 5 * 4)
    return {
        "flops": float(flops),
        "bytes": float(bytes_moved),
        "t_compute": flops / peak_flops,
        "t_memory": bytes_moved / peak_bw,
        "sol_time": max(flops / peak_flops, bytes_moved / peak_bw),
    }


class StepRater:
    """Rolling steps/s + pixels/s meter for train loops."""

    def __init__(self, pixels_per_step: int, window: int = 50):
        self.pixels = pixels_per_step
        self.window = window
        self.times = []

    def tick(self) -> Optional[Dict[str, float]]:
        self.times.append(time.perf_counter())
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 2:
            return None
        dt = (self.times[-1] - self.times[0]) / (len(self.times) - 1)
        return {"steps_per_s": 1.0 / dt, "rays_per_s": self.pixels / dt}
