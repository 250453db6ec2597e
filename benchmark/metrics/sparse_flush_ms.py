"""Host milliseconds per flush of the sparse tracker: its `sparse.flush`
span (every fourth frame: the keyframes' batched read and insertion, the
retrieval, verification, BA fetch and apply and PGO stages of the lagged
pipeline), over the counted frames (`spans.py`).  Printed beside it: the
share of the flushes spent in their `host.read` spans, and the front end
plus the flushes a frame against `sparse_track_host_ms`."""

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "sparse tracker (tracking/sparse.py, parallel/ba.py)"
MOVES = "frame_ms_p95"
SOURCE = "program_span"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    flushes = spans.spans(st, "sparse.flush")
    if not flushes:
        return None
    flush_ms = statistics.fmean(r.ms for r in flushes)
    tracks = spans.spans(st, "frame.sparse_track")
    front = {r.frame: r.ms for r in spans.spans(st, "sparse.detect")}
    for r in spans.spans(st, "sparse.match_pose"):
        front[r.frame] = front.get(r.frame, 0.0) + r.ms
    outside = ctx.probes.get("sparse_track_s")
    if tracks and front:
        per_frame = statistics.fmean(front.values()) + flush_ms * len(flushes) / len(tracks)
        spans.log(f"sparse: front end + flushes a frame {per_frame:.4f} ms ({len(flushes)} "
                  f"flushes in {len(tracks)} frames); frame.sparse_track span "
                  f"{statistics.fmean(r.ms for r in tracks):.4f}; sparse_track_host_ms's "
                  "wrapper " + (f"{1e3 * statistics.fmean(outside):.4f} over {len(outside)}"
                                if outside else "not read"))
    spans.log(f"sparse.flush: host.read share {spans.read_share(st, flushes, 'sparse.flush'):.2f}%")
    return flush_ms
