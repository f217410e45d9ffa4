"""Card idle ms per train step that falls outside every program span: the
host work of the loop between ``train.step``s (reading the drop counters,
the next frame)."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.idle_ms(ctx)
