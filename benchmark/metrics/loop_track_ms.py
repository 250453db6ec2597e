"""Host milliseconds of the local loop check's `loop.track` span per check
that reached it (the ACTIVE render, the model pyramids, the op-by-op dense
track and its gate read), over the counted frames' checks that no check
copied (`spans.py`).  Printed beside it: the `loop.check` span's mean
against `loop_check_ms`, and the share of `loop.track` spent in its
`host.read` spans (the host waiting on the card)."""

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "loops (loops.py try_local_loop, mapping/ferns.py, mapping/deformation.py)"
MOVES = "frame_ms_p95"
SOURCE = "program_span"


def install(ctx):
    spans.install(ctx)


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    tracks = spans.spans(st, "loop.track", loops_only=True)
    checks = spans.spans(st, "loop.check", loops_only=True)
    outside = ctx.probes.get("loop_check_s")
    if checks:
        spans.log(f"loop.check span: mean {statistics.fmean(r.ms for r in checks):.4f} ms over "
                  f"{len(checks)} checks; loop_check_ms's wrapper: "
                  + (f"{1e3 * statistics.fmean(outside):.4f} ms over {len(outside)}"
                     if outside else "not read"))
    if not tracks:
        return None
    spans.log(f"loop.track: {len(tracks)} checks reached it; host.read share "
              f"{spans.read_share(st, tracks, 'loop.track'):.2f}%")
    return statistics.fmean(r.ms for r in tracks)
