"""Host milliseconds by which a frame's hand-over lags its due time, the
95th percentile.  On a schedule (the traffic's ``rate_hz`` > 0) every
frame of a tick is due at the tick's time; the harness hands it over when
that time comes and the host has handed over the frames before it.  The
harness notes both times of the window's frames before the traced span
that no check copies (`spans.py`'s frames).  This is the part of
`frame_ms_p95` spent waiting behind the host; the rest comes after the
hand-over.  Back to back a frame has no due time, and nothing is read."""

import statistics

UNIT = "ms"
LAYER = "harness"
MOVES = "frame_ms_p95"
SOURCE = "host_clock"


def read(ctx):
    lags = [handed - due for due, handed in ctx.handovers]
    if len(lags) < 2:
        return None
    return 1e3 * statistics.quantiles(lags, n=100)[94]
