"""Device milliseconds per frame of the graphed step: CUDA events that the
harness records on the stream just before and just after the camera's
`step_fn` (the CUDA graph replay that `frame.dense_step` launches),
averaged over the window's frames before the traced span (the profiler's
own cost is in the span's, and outlasts it)."""

UNIT = "ms"
LAYER = "step (step.py graphed step, utils/graphs.py)"
MOVES = "fps"
SOURCE = "device_trace"


def read(ctx):
    pairs = ctx.probes.get("step_events")
    if not pairs:
        return None
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)
