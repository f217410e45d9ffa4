"""Device ms per train step of the kernels launched inside the program's
``train.update`` span (``train.loop.apply_update``: ``track_stats``, GroupAdam,
the SH degree)."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.device_ms(ctx, _ps.UPDATE)
