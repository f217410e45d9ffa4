"""Device ms per train step of the kernels launched while the program's
``train.backward`` span (the ``torch.autograd.grad`` of
``train.loop.loss_and_grads``) is open: the whole backward of the step."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.device_ms(ctx, _ps.BACKWARD)
