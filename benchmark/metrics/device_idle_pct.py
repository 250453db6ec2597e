"""Share of a frame's time in which no kernel, copy or fill runs on the
card: one minus the device's busy time a frame in the traced span (the
union of the device operations' intervals over every stream,
`tracing.Trace`, over the span's frames) over the host's time a frame
before the span, where no profiler runs.  The profiler's own cost on the
host lengthens the span's frames; it does not lengthen the device's
operations, so the busy time is read in the span and the frame's length
outside it."""

UNIT = "%"
LAYER = "device"
MOVES = "fps"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or ctx.span_frames <= 0 or not ctx.pre_span_frames:
        return None
    busy = tr.busy_s / ctx.span_frames
    period = ctx.pre_span_s / ctx.pre_span_frames
    return 100.0 * (1.0 - busy / period)
