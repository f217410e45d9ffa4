"""Device ms per train step of the kernels launched inside the program's
``human.forward`` span (``avatar.human.human_forward``): the human's forward
only; its backward runs inside ``train.backward``."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.device_ms(ctx, _ps.HUMAN)
