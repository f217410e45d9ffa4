"""``torch.cuda.max_memory_allocated`` over the traced train steps, after a
reset of the peak, in GiB."""


def read(ctx):
    return ctx.peak / 2**30 if ctx.peak else None
