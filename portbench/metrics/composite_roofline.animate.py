"""The compositing kernels' least time per animate frame (``counts/``, on the
reference's renders of the compared frames) over their device time per frame
(the profile), in percent."""
import harness

_ck = harness.load_reader("composite_kernels")


def read(ctx):
    s = _ck.seconds(ctx.trace)
    work = getattr(ctx, "work", None)
    if s is None or not work or work["least_s"] <= 0:
        return None
    return 100.0 * work["least_s"] / (s / ctx.units)
