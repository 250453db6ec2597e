"""Host milliseconds per frame of the sparse tracker's front end: the
`sparse.detect` span (FAST and BRIEF over the pyramid) plus the
`sparse.match_pose` span (matching and the motion-only pose), both queued
on the card without a read, over the counted frames (`spans.py`)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "sparse tracker (tracking/sparse.py, parallel/ba.py)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    per_frame = {r.frame: r.ms for r in spans.spans(st, "sparse.detect")}
    for r in spans.spans(st, "sparse.match_pose"):
        if r.frame in per_frame:
            per_frame[r.frame] += r.ms
    return spans.mean(per_frame.values())
