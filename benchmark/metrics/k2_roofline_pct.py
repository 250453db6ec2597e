"""Kernel K2 (the whole-map deformation, `csrc/deform.cu` via
`ops/deform.py`) against its roofline over the window's calls: the sum of
each call's bound (`roofline.deform_work` from the rows below the count,
the live rows among them and the graph's nodes: what the call was given,
counted on the card without a wait and read after the window) over the sum
of the calls' device time, from CUDA events recorded just before and after
each call (its node-table prologue and map kernel); calls from the traced
span on, and calls whose state a check copies, are left out."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import roofline  # noqa: E402

UNIT = "%"
LAYER = "kernel K2 (csrc/deform.cu via ops/deform.py)"
MOVES = "frame_ms_p95"
SOURCE = "device_trace"
CONF_COL = 3  # the map row's confidence column (`mapping/surfel_map.py`)


def install(ctx):
    import torch
    from densemonoslam_tpu_torch.ops import deform

    if ctx.device.type != "cuda":
        return
    inner = deform.deform_map
    calls = ctx.probes.setdefault("k2_calls", [])

    def timed(data, count, graph):
        if not ctx.in_window or ctx.traced or ctx.probing:
            return inner(data, count, graph)
        # what the call is given, kept on the card without a read: its
        # count and the live rows below it, read after the window
        n = count.detach().clone()
        rows = torch.arange(data.shape[0], device=data.device) < n
        live = ((data[:, CONF_COL] > 0) & rows).sum()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(data, count, graph)
        e.record()
        calls.append((s, e, n, live, graph.pos.shape[0]))
        return out

    deform.deform_map = timed


def read(ctx):
    calls = ctx.probes.get("k2_calls")
    if not calls:
        return None
    bound = sum(roofline.bound_s(*roofline.deform_work(int(n), int(live), k))
                for _, _, n, live, k in calls)
    dev_s = sum(s.elapsed_time(e) for s, e, _, _, _ in calls) * 1e-3
    return 100.0 * bound / dev_s
