"""Device ms per train step of the kernels launched inside the program's two
``face.render`` spans (the face-mesh renders of ``avatar.model.forward_frame``:
binning, z-test, UV sample, embedding), forward only."""
import harness

_ps = harness.load_reader("program_spans")


def read(ctx):
    return _ps.device_ms(ctx, _ps.FACE)
