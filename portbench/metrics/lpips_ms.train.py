"""Device ms per train step of the kernels launched inside the program's two
``loss.lpips`` spans (``avatar.losses.lpips_loss``), forward only."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.device_ms(ctx, _ps.LPIPS)
