"""Device milliseconds of the graphed step's render branch on the frames
that rendered: from the stamp at the branch's start to the stamp at its
end, less the fuse branch inside it (`step.stage_ms`: the ACTIVE splat
render and the stored prediction's copies), stamps captured inside the
branch's IF body, over the counted frames (`spans.py`)."""

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
    return spans.mean(ms for _, ms in st["stages"]["render"])
