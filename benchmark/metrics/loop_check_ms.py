"""Host wall milliseconds per local loop check in the window: the time of
each `loops.try_local_loop` call (the inactive render, `loop.track`,
constraints, the graphed GN-CG and, when accepted, K2 and the pose), with
the module attribute that `Engine.process_frame` calls wrapped; calls from
the traced span on (the profiler's cost outlasts its span), and calls
whose input state a check copies (the copy holds the first gate's read),
are left out."""

import time

UNIT = "ms"
LAYER = "loops (loops.py try_local_loop, mapping/ferns.py, mapping/deformation.py)"
MOVES = "frame_ms_p95"
SOURCE = "program_span"


def install(ctx):
    from densemonoslam_tpu_torch import loops

    inner = loops.try_local_loop
    times = ctx.probes.setdefault("loop_check_s", [])

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        if ctx.in_window and not ctx.traced and not ctx.probing:
            times.append(time.perf_counter() - t)
        return out

    loops.try_local_loop = timed


def read(ctx):
    times = ctx.probes.get("loop_check_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
