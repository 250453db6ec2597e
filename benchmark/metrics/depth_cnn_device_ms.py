"""Device milliseconds per frame of the depth CNN: the timing CUDA events of
the engine's `frame.depth_cnn` span (recorded on the stream around
`DepthPredictor.predict`, never waited on, read after the window), over
the counted frames (`spans.py`).  On the CPU, where the net runs on the
host, the span's host milliseconds."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "depth CNN (models/depthnet.py)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    ms = [st["timer"].device_ms(r) if r.events is not None else (None if ctx.on_card else r.ms)
          for r in spans.spans(st, "frame.depth_cnn")]
    return spans.mean(m for m in ms if m is not None)
