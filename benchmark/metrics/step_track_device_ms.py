"""Device milliseconds per frame of the graphed step's tracking stage: from
the stamp at the step's start to the stamp after `odometry.track`
(preprocess, the pyramids, SO3 and ICP+RGB), both kernels captured in the
step's CUDA graph (`step.py`, `utils/timer.py` `StageRing`), read once
after the window through `Engine.stage_ms`, over the counted frames
(`spans.py`).  Printed beside it: the stamps' step total (start to end
stamp) against the events of `step_device_ms` around the replay."""

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "step (step.py graphed step, utils/graphs.py)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    total = [ms for _, ms in st["stages"]["step"]]
    events = ctx.probes.get("step_events")
    if total and events:
        ev = [a.elapsed_time(b) for a, b in events]
        spans.log(f"stamps: step total median {statistics.median(total):.4f} ms, mean "
                  f"{statistics.fmean(total):.4f} over {len(total)} frames; step_device_ms's "
                  f"events median {statistics.median(ev):.4f}, mean {statistics.fmean(ev):.4f} "
                  f"over {len(ev)}; medians' ratio "
                  f"{100.0 * statistics.median(total) / statistics.median(ev):.2f}%")
    return spans.mean(ms for _, ms in st["stages"]["track"])
