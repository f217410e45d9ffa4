"""Reads of device values by the host per train step: the program's
``sync.*`` spans inside ``train.step`` (the window origins' ``int()``, the
face-mesh binning's ``tolist()``). Each waits for the card; the step's other
waits, its blocking copies of host constants to the card, have no span and
are not counted."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.syncs(ctx, _ps.STEP)
