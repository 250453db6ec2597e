"""Host milliseconds per frame of the sparse tracker's `track` (what the
`frame.sparse_track` range covers: detection, matching and the motion-only
pose queued on the card, and every fourth frame the lagged flush with its
keyframe, loop and local BA stages), the camera's tracker's method wrapped,
over the window's frames before the traced span (the profiler's cost on
the host outlasts its span)."""

import time

UNIT = "ms"
LAYER = "sparse tracker (tracking/sparse.py, parallel/ba.py)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    tr = ctx.frontend.sparse_tracker
    if tr is None:
        return
    inner = tr.track
    times = ctx.probes.setdefault("sparse_track_s", [])

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        if ctx.in_window and not ctx.traced:
            times.append(time.perf_counter() - t)
        return out

    tr.track = timed


def read(ctx):
    times = ctx.probes.get("sparse_track_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
