"""What the per-layer metrics of the program's own spans, stage stamps and
loop counters read (`densemonoslam_tpu_torch/utils/timer.py`).

`install(ctx)` (once a run, from each such metric's `install`) turns the
port's span recorder on, so a `--trace 1` run records spans over its whole
window and a `--trace 0` run leaves it off, and notes which frames count:
those the harness hands over inside the window, before the traced span
(the profiler's cost outlasts it), and with no check copying their state
(`ctx.probing`, read when the frame is handed over; for a loop check, when
the check is called, since the closure check probes from around it).  A
frame is known by its id, the engine's session tick when it starts, which
every span of the frame and every stamp of its step carries.

On a program without the recorder, the stamps or the counters nothing is
noted, and each reader returns None.  The first read also prints the tail
line: for the slowest 5% of the counted frames by their `frame` span, the
mean host ms of each span inside it and the mean device ms of each stage
of the step.
"""

from __future__ import annotations

import math
import statistics
import sys
from collections import defaultdict
from typing import Dict, List, Optional


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def install(ctx) -> None:
    if "spans" in ctx.probes:
        return
    st = ctx.probes["spans"] = {"on": False, "kept": set(), "probed": set(), "current": None}
    from densemonoslam_tpu_torch import loops
    from densemonoslam_tpu_torch.utils import timer

    eng, fe = ctx.engine, ctx.frontend
    if not (hasattr(timer, "enable") and hasattr(eng, "stage_ms") and hasattr(fe, "loop_checks")):
        return
    st.update(on=True, timer=timer, counts0=(fe.loop_checks, fe.loops_closed))
    st["counts"] = st["counts0"]
    timer.reset()
    timer.enable()
    inner_frame = eng.process_frame

    def frame(*a, **k):
        fid = st["current"] = eng.global_tick
        keep = ctx.in_window and not ctx.traced and not ctx.probing
        out = inner_frame(*a, **k)
        if keep:
            st["kept"].add(fid)
            st["counts"] = (fe.loop_checks, fe.loops_closed)
        return out

    eng.process_frame = frame
    inner_loop = loops.try_local_loop

    def check(*a, **k):
        if ctx.probing:
            st["probed"].add(st["current"])
        return inner_loop(*a, **k)

    loops.try_local_loop = check


def state(ctx) -> Optional[dict]:
    """The run's notes, once the window is over (None where nothing was
    recorded); the first call reads the spans and stamps and prints the
    tail line."""
    st = ctx.probes.get("spans")
    if not st or not st["on"] or not st["kept"]:
        return None
    if "recs" not in st:
        st["recs"] = st["timer"].spans()
        if len(st["recs"]) >= st["timer"].CAPACITY:
            log(f"spans: the recorder's {st['timer'].CAPACITY} records ran out")
        stages = ctx.engine.stage_ms(ctx.frontend.name)
        st["stages"] = {k: [(t, ms) for t, ms in v if t in st["kept"]] for k, v in stages.items()}
        _tail(ctx, st)
    return st


def spans(st: dict, name: str, loops_only: bool = False) -> list:
    """The counted frames' spans named `name` (with `loops_only`, those of
    loop checks no check copied)."""
    keep = st["kept"] - st["probed"] if loops_only else st["kept"]
    return [r for r in st["recs"] if r.name == name and r.frame in keep]


def read_share(st: dict, parents: List, name: str) -> float:
    """The share of the `parents` spans' host time spent in `host.read`
    spans inside them, at any depth (the parents are spans named `name`)."""
    ids = {id(p) for p in parents}
    recs, total = st["recs"], 0
    for r in recs:
        if r.name != "host.read":
            continue
        i = r.parent
        while i >= 0 and recs[i].name != name:
            i = recs[i].parent
        if i >= 0 and id(recs[i]) in ids:
            total += r.end_ns - r.start_ns
    whole = sum(p.end_ns - p.start_ns for p in parents)
    return 100.0 * total / whole if whole else math.nan


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _tail(ctx, st: dict) -> None:
    recs = st["recs"]
    frames = {r.frame: r for r in recs
              if r.name == "frame" and r.parent < 0 and r.frame in st["kept"]}
    if not frames:
        return
    order = sorted(frames, key=lambda f: frames[f].ms, reverse=True)
    tail = set(order[: max(1, math.ceil(0.05 * len(order)))])
    host: Dict[str, float] = defaultdict(float)
    for r in recs:
        if r.frame in tail and r.parent >= 0:
            host[r.name] += r.ms
    dev = {k: mean(ms for t, ms in v if t in tail) for k, v in st["stages"].items()}
    parts = ", ".join(f"{k} {v / len(tail):.3f}"
                      for k, v in sorted(host.items(), key=lambda kv: -kv[1]))
    stages = ", ".join(f"{k} {v:.3f}" for k, v in dev.items() if v is not None)
    log(f"tail: the slowest {len(tail)} of {len(frames)} counted frames by their frame span "
        f"(mean {statistics.fmean(frames[f].ms for f in tail):.3f} ms, all frames "
        f"{statistics.fmean(r.ms for r in frames.values()):.3f}); host ms a frame by span: "
        f"{parts}; step stages' device ms: {stages or 'none'}")
