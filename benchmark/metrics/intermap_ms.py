"""Host milliseconds per inter-map query in the window: each `loop.intermap`
span (`Engine._try_intermap`: the frame's fern code and pyramid, the other
map's fern lookup, and where a candidate passes, `loops.verify_recovery`:
the render of the whole other map, the dense track and the gates' reads)
of a frame in which the camera's `Frontend.intermap_checks` rose (a query
reached `loops.resolve_intermap`), less the `merge.*` spans inside it,
which `merge_ms` reads.  Every camera's queries count, those of frames
handed over before the traced span (the profiler's cost outlasts it),
including the query a check copies, since its probes add only device
copies.  The mean over those queries: in a cell where a camera's checks
skip a map with no fern database and one map is left after the merge,
that is the run's single verifying query, one sample a run.  Printed
beside it: the counters `intermap_checks` and `intermap_merges` summed
over the cameras.  On a program without those counters nothing is
read."""

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "inter-map (engine.py _try_intermap, loops.py resolve_intermap)"
MOVES = "fps"
SOURCE = "program_span"


def install(ctx):
    """The span recorder on (`spans.install`), and each window frame
    handed over before the traced span noted by its id with its camera,
    and those in which the camera's query counter rose."""
    spans.install(ctx)
    if "intermap_frames" in ctx.probes:
        return
    frames = ctx.probes["intermap_frames"] = {}
    queries = ctx.probes["intermap_queries"] = set()
    eng = ctx.engine
    inner = eng.process_frame

    def frame(name, *a, **k):
        if not ctx.in_window or ctx.traced:
            return inner(name, *a, **k)
        fid = eng.global_tick
        frames[fid] = name
        before = getattr(eng.frontends[name], "intermap_checks", None)
        out = inner(name, *a, **k)
        if before is not None and eng.frontends[name].intermap_checks > before:
            queries.add(fid)
        return out

    eng.process_frame = frame


def counters(ctx):
    """(queries, merges) summed over the cameras, or None on a program
    without the counters."""
    fes = list(ctx.frontends.values())
    if not all(hasattr(fe, "intermap_checks") and hasattr(fe, "intermap_merges") for fe in fes):
        return None
    return sum(fe.intermap_checks for fe in fes), sum(fe.intermap_merges for fe in fes)


def inside(recs, i: int, names) -> list:
    """The records below record `i` (at any depth) whose name is in `names`."""
    out = []
    for r in recs[i + 1:]:
        if r.start_ns >= recs[i].end_ns:
            break
        j = r.parent
        while j > i:
            j = recs[j].parent
        if j == i and r.name in names:
            out.append(r)
    return out


MERGE = ("merge.maps", "merge.compact", "merge.members")


def read(ctx):
    counts = counters(ctx)
    st = spans.state(ctx)
    frames = ctx.probes.get("intermap_frames")
    if counts is None or st is None or not frames:
        return None
    recs = st["recs"]
    queries = ctx.probes.get("intermap_queries", set())
    calls = [(i, r) for i, r in enumerate(recs) if r.name == "loop.intermap" and r.frame in queries]
    spans.log(f"inter-map: queries {counts[0]}, merges {counts[1]} (the counters); "
              f"{sum(r.name == 'loop.intermap' and r.frame in frames for r in recs)} loop.intermap "
              f"spans before the traced span, {len(calls)} of them with a query")
    if not calls:
        return None
    ms = [r.ms - sum(m.ms for m in inside(recs, i, MERGE)) for i, r in calls]
    spans.log("inter-map queries (frame, ms less the merge, ms): " + ", ".join(
        f"({r.frame}, {m:.4f}, {r.ms:.4f})" for (_, r), m in zip(calls, ms)))
    return statistics.fmean(ms)
