"""Share of the local loop checks attempted that closed a loop: 100 times
the change in `Frontend.loops_closed` over the change in
`Frontend.loop_checks`, from the window's start to its last counted frame
before the traced span (`spans.py`).  Checks whose state a check copies
count too: the copies change no decision, and leaving out calls chosen by
their outcome (the closure check copies until one is accepted) would bias
the share."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "%"
LAYER = "loops (loops.py try_local_loop, mapping/ferns.py, mapping/deformation.py)"
MOVES = "frame_ms_p95"
SOURCE = "program_counter"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    (checks0, closed0), (checks1, closed1) = st["counts0"], st["counts"]
    if checks1 <= checks0:
        return None
    spans.log(f"loop checks: {closed1 - closed0} of {checks1 - checks0} accepted")
    return 100.0 * (closed1 - closed0) / (checks1 - checks0)
