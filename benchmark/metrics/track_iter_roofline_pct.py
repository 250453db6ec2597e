"""Kernel K1 in its fused form (the whole tracking iteration,
`csrc/track_iter.cu` via `ops/track_iter.py`) against its own roofline over
the traced span: the sum of each launch's bound over the sum of its
kernels' device time in the trace.  A launch's bound is the bytes the least
of its rows reads: a Gauss-Newton row its frame maps (vertex, normal,
intensity: 7 floats) and a 12-float model sample or nearest texel, an SO3
row its intensity and an 8-float sample; bilinear gathers, the sample an
iteration writes and the carry are left out, so the share can only read
lower than the truth.  The launches by shape are the span's change in
`utils.launches` under K1's ``("gram", (P, C))`` (C = 16 a GN iteration, 8
an SO3 one), each of them a fused iteration where ``("track_iter", mode)``
counts as many; the kernels are found by name.  Where the counts and the
trace disagree, or the program has no fused iteration, nothing is read."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import roofline  # noqa: E402

UNIT = "%"
LAYER = "kernel K1 (csrc/gram.cu via ops/gram.py)"
MOVES = "fps"
SOURCE = "device_trace"
KERNEL_NAMES = ("track_iter_gram_kernel",)
ROW_BYTES = {16: 4.0 * (7 + 12), 8: 4.0 * (1 + 8)}  # the least a GN / an SO3 row reads


def read(ctx):
    if ctx.trace is None:
        return None
    shapes = {s: n for (k, s), n in ctx.launches.items() if k == "gram" and n > 0}
    fused = sum(n for (k, _), n in ctx.launches.items() if k == "track_iter")
    kernels = ctx.trace.kernels(KERNEL_NAMES)
    n = sum(shapes.values())
    if not kernels or fused != n or len(kernels) != n or any(C not in ROW_BYTES
                                                             for _, C in shapes):
        print(f"[bench] track_iter_roofline_pct: {len(kernels)} fused kernels traced, {fused} "
              f"fused launches and {n} K1 launches counted", file=sys.stderr)
        return None
    bound = sum(c * roofline.bound_s(ROW_BYTES[C] * P, 0.0) for (P, C), c in shapes.items())
    return 100.0 * bound / sum(e - s for s, e in kernels)
