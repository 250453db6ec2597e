"""Host milliseconds of the window's first inter-map merge, from its start
to the end of the moved camera's first step after it: the merge's spans
(`merge.maps`: A's rows moved and appended to B, with its read of the
counts; `merge.compact`: the merged map re-partitioned; `merge.members`:
the carried constraints, poses, pose histories and ferns moved and the
map handed to every member) plus the moved camera's next
`frame.dense_step`, where on the card its step is captured again over the
merged map (`step.capture`, with the capture's warm-up copy of the map).
It is read on the merge a check copies too, since its probes add only
device copies.  The parts are printed beside it.  On a program without
the counters `Frontend.intermap_checks` and `intermap_merges` nothing is
read."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import intermap_ms  # noqa: E402
import spans  # noqa: E402

UNIT = "ms"
LAYER = "inter-map (engine.py _try_intermap, loops.py resolve_intermap)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    intermap_ms.install(ctx)


def read(ctx):
    counts = intermap_ms.counters(ctx)
    st = spans.state(ctx)
    frames = ctx.probes.get("intermap_frames")
    if counts is None or not counts[1] or st is None or not frames:
        return None
    recs = st["recs"]
    first = next((r for r in recs if r.name == "merge.maps" and r.frame in frames), None)
    if first is None:
        return None
    parts = [r for r in recs if r.name in intermap_ms.MERGE and r.frame == first.frame
             and r.parent == first.parent]
    moved = frames[first.frame]
    later = [f for f, name in frames.items() if name == moved and f > first.frame]
    if not later:
        return None
    step = [(i, r) for i, r in enumerate(recs)
            if r.name == "frame.dense_step" and r.frame == min(later)]
    if not step:
        return None
    i, step = step[0]
    capture = intermap_ms.inside(recs, i, ("step.capture",))
    spans.log("merge: " + ", ".join(f"{r.name} {r.ms:.4f}" for r in parts)
              + f" ms; {moved}'s next frame.dense_step {step.ms:.4f} ms (frame {step.frame}), "
              + (f"step.capture {capture[0].ms:.4f} ms in it" if capture else "no capture in it"))
    return sum(r.ms for r in parts) + step.ms
