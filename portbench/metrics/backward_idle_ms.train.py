"""Card idle ms per train step while the program's ``train.backward`` span is
open: the backward's launches and its other host work leave the card
waiting."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.idle_ms(ctx, _ps.BACKWARD)
