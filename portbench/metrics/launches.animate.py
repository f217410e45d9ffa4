"""Device kernels per animate frame in the profile (the program's own launch
counters of kernels 1-8 are printed beside it on standard error)."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.units if ctx.trace.kernels else None
