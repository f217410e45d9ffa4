"""The step's share of the card's float32 peak (67 TFLOP/s: TF32 is off),
in percent: FLOPs of the reference's first compared step (matmuls and
convolutions, forward and backward, by ``FlopCounterMode``) plus the
compositing operations of ``counts/`` per step, over the traced host time
per step."""
from counts.composite import PEAK_F32_FLOPS


def read(ctx):
    work = getattr(ctx, "work", None)
    flops = getattr(ctx, "flops_first_step", None)
    if not work or flops is None:
        return None
    return 100.0 * (flops + work["ops"]) / (ctx.unit_s * PEAK_F32_FLOPS)
