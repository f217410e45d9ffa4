"""The program's own spans (``utils.profiling.span`` in the port) that the
``program_span`` readers read, and their arithmetic. A program without
these spans leaves every such reader at None."""
import harness

STEP = "train.step"  # one unit of a train cell
HUMAN = "human.forward"
FACE = "face.render"
LPIPS = "loss.lpips"
BACKWARD = "train.backward"  # the autograd thread's launches fall inside it
UPDATE = "train.update"
SYNC = "sync."  # prefix of the spans around the reads of device values


def device_ms(ctx, span: str):
    """Device ms per unit of the kernels launched inside ``span``."""
    ks = harness.kernels_in_span(ctx.trace, span)
    return None if ks is None else 1e3 * sum(k[2] for k in ks) * 1e-6 / ctx.units


def syncs(ctx, unit: str):
    """``sync.*`` spans per unit that open inside a ``unit`` span; None
    where the trace has no ``unit`` span."""
    units = [(a, b) for n, a, b in ctx.trace.spans if n == unit]
    if not units:
        return None
    n = sum(1 for name, a, _ in ctx.trace.spans
            if name.startswith(SYNC) and any(u0 <= a <= u1 for u0, u1 in units))
    return n / ctx.units


def _idle_inside_us(gaps, intervals) -> float:
    """Microseconds of the sorted ``gaps`` that the merged ``intervals``
    cover."""
    out, j = 0.0, 0
    for a, b in gaps:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return out


def idle_ms(ctx, span=None):
    """Card idle ms per unit between its kernels, copies and sets: the part
    inside the ``span`` spans, or with ``span`` None the part outside every
    program span (the caller's own code between units). None where the
    trace has no such span or no device work. The traced run's own
    annotations are no program spans."""
    harness_marks = set(harness.SPANS.values())
    spans = [(a, b) for n, a, b in ctx.trace.spans
             if n not in harness_marks and (span is None or n == span)]
    if not spans or not ctx.trace.device:
        return None
    busy = harness.merged(ctx.trace.device)
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
    inside = _idle_inside_us(gaps, harness.merged(spans))
    us = inside if span is not None else sum(b - a for a, b in gaps) - inside
    return 1e-3 * us / ctx.units
