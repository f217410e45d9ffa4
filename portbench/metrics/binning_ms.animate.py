"""Device ms per animate frame of the kernels launched inside the program's
``ops.rasterizer.api.prepare`` (projection, binning and the depth-sorted
gather), which the traced run wraps in an
annotation. None where the annotation is missing."""
import harness


def read(ctx):
    ks = harness.kernels_in_span(ctx.trace, harness.SPANS["prepare"])
    return None if ks is None else 1e3 * sum(k[2] for k in ks) * 1e-6 / ctx.units
