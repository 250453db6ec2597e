"""Device milliseconds of the graphed step's fuse branch on the frames that
fused: from the stamp at the branch's start to the stamp at its end
(`fusion.fuse_window`, `place_updates`, the fill-in), stamps captured
inside the nested IF body, over the counted frames (`spans.py`)."""

import os
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
    return spans.mean(ms for _, ms in st["stages"]["fuse"])
