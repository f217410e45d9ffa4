"""Operations and bytes of the compositing kernels (the program's kernels
1-8) and their least time on one H100, by the formula the program's kernel
table uses:

  forward  = max(visits x 13 ops / 67 TFLOP/s,
                 (live pairs x 40 B + tile pixels x 20 B) / 3.35 TB/s)
  backward = max((visits x 13 + contributing visits x 45) / 67 TFLOP/s,
                 (live pairs x 80 B + tile pixels x 40 B) / 3.35 TB/s)

13: ~12 float32 operations and an exp per (pixel, row) visit; 45: the
backward's 35 operations per contributing visit and the 10 adds that sum its
values over pixels; 40 B: the 10 used float32 channels of a pair's row, read
(and in the backward also its gradient written); 20 B / 40 B per pixel: the
5 float32 outputs (and their cotangents). The visits, contributing visits
and pairs are counted by the reference's compositor on its own renders, by
renderCUDA's rules (``reference/ops/rasterizer/api.py``), so the count is of
the work and not of whatever implements it.
"""
from __future__ import annotations

from reference.ops.rasterizer.api import COUNTS  # noqa: F401  (re-exported)

# H100 SXM (NVIDIA's data sheet, dense): float32 outside the tensor cores,
# which is what a TF32-off run has, and HBM3 bandwidth, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_VISIT = 13
OPS_PER_HIT = 45
BYTES_PER_PAIR = 40
BYTES_PER_PIXEL = 20


def forward_ops(visits: int) -> float:
    return float(visits) * OPS_PER_VISIT


def backward_ops(visits: int, hits: int) -> float:
    return float(visits) * OPS_PER_VISIT + float(hits) * OPS_PER_HIT


def forward_least_s(pairs: int, pixels: int, visits: int) -> float:
    return max(forward_ops(visits) / PEAK_F32_FLOPS,
               (pairs * BYTES_PER_PAIR + pixels * BYTES_PER_PIXEL) / PEAK_BYTES)


def backward_least_s(pairs: int, pixels: int, visits: int, hits: int) -> float:
    return max(backward_ops(visits, hits) / PEAK_F32_FLOPS,
               (pairs * 2 * BYTES_PER_PAIR + pixels * 2 * BYTES_PER_PIXEL) / PEAK_BYTES)


def work_per_unit(counts, units: int) -> dict:
    """The launches ``counts`` recorded over ``units`` steps or frames, per
    unit: least seconds, compositing operations, visits and pairs."""
    least = (sum(forward_least_s(*f) for f in counts.fwd)
             + sum(backward_least_s(*b) for b in counts.bwd))
    ops = (sum(forward_ops(f[2]) for f in counts.fwd)
           + sum(backward_ops(b[2], b[3]) for b in counts.bwd))
    return {"least_s": least / units, "ops": ops / units,
            "visits": sum(f[2] for f in counts.fwd) / units,
            "pairs": sum(f[0] for f in counts.fwd) / units,
            "launches": (len(counts.fwd) + len(counts.bwd)) / units}
