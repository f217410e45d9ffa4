"""Device ms per animate frame of the compositing kernels (the program's
kernels 1-8, named in ``composite_kernels.py``), from the profile."""
import harness

_ck = harness.load_reader("composite_kernels")


def read(ctx):
    s = _ck.seconds(ctx.trace)
    return None if s is None else 1e3 * s / ctx.units
