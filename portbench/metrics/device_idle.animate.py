"""The share of the traced window in which no kernel, copy or set ran on
the card, in percent."""
import harness


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - harness.busy_seconds(ctx.trace) / ctx.trace.window_s)
