"""Device ms per animate frame of the kernels launched inside the program's
``avatar.human.human_forward`` as ``apps.animate`` calls it (under
no_grad), which the traced run wraps in an annotation."""
import harness


def read(ctx):
    ks = harness.kernels_in_span(ctx.trace, harness.SPANS["human_forward"])
    return None if ks is None else 1e3 * sum(k[2] for k in ks) * 1e-6 / ctx.units
