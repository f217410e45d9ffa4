"""The program's compositing kernels by symbol name, and their device
seconds in a trace (None where none ran)."""

KERNELS = (
    "composite_tiles_fwd_cm_kernel", "composite_tiles_bwd_cm_kernel",  # 1, 2: dense
    "composite_tiles_fwd_v2_kernel", "composite_tiles_bwd_v2_kernel",  # 3, 4: kernel_v=2
    "composite_tiles_fwd_kernel", "composite_tiles_bwd_kernel",  # 5, 6: row-major, origins
    "composite_pairs_fwd_rg_kernel", "composite_pairs_bwd_rg_kernel",  # 7, 8: pair-major
)


def is_composite(name: str) -> bool:
    return any(k in name for k in KERNELS)


def seconds(trace):
    ks = [k for k in trace.kernels if is_composite(k[0])]
    return sum(k[2] for k in ks) * 1e-6 if ks else None
