"""Card idle ms per animate frame that falls outside every program span: the
host work of the loop between ``animate.frame``s (the image's copy to the
host)."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.idle_ms(ctx)
