"""Kernel K1 (the Gram reduction, `csrc/gram.cu` via `ops/gram.py`) against
its roofline over the traced span: the sum of each launch's bound (from its
shape, `roofline.gram_work`) over the sum of its kernels' device time in the
trace.  The launches by shape are the span's change in `utils.launches`
(graph replays and their branch bodies included); the kernels are found by
name.  Where the trace holds another number of K1 kernels than the counts
say, the two cannot be matched and nothing is read."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import roofline  # noqa: E402

UNIT = "%"
LAYER = "kernel K1 (csrc/gram.cu via ops/gram.py)"
MOVES = "fps"
SOURCE = "device_trace"
KERNEL_NAMES = ("gram_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    shapes = {s: n for (k, s), n in ctx.launches.items() if k == "gram" and n > 0}
    kernels = ctx.trace.kernels(KERNEL_NAMES)
    n = sum(shapes.values())
    if not kernels or len(kernels) != n:
        print(f"[bench] k1_roofline_pct: {len(kernels)} K1 kernels traced, {n} launches counted",
              file=sys.stderr)
        return None
    bound = sum(c * roofline.bound_s(*roofline.gram_work(P, C)) for (P, C), c in shapes.items())
    return 100.0 * bound / sum(e - s for s, e in kernels)
