"""The traced span of a `--trace 1` run, and what is read from it.

`Tracer` starts `torch.profiler` (CPU and CUDA activities) at the first
frame boundary `trace.start_s` seconds into the window and stops it at the
first boundary `trace.span_s` seconds later (or at the window's end), so
the span holds whole frames chosen by time.  While it runs, the sync debug
mode is ``"warn"`` (each synchronising call the program makes is one
warning, counted), and the kernels' launch counts (`utils.launches`, the
graph bodies' settled from the device) are taken at both ends.  Each frame
handed over inside the span is a ``bench.frame`` range.

`Trace` holds the span's device operations (kernels, copies, fills) and
host ranges from the profiler's Chrome trace: the device's busy time is
the union of its operations' intervals over every stream, never their sum.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_RANGE = "bench.frame"
NAME_CHARS = 200  # of an operation's name in the breakdown


def frame_range(tracer):
    """A ``bench.frame`` range while the tracer runs, else nothing."""
    if tracer is None or not tracer.running:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(FRAME_RANGE)


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals, sorted."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """Device operations and host ranges of the span; times in seconds on
    the trace's clock."""

    def __init__(self, events: list):
        self.ops = []  # (name, start, end, stream)
        self.ranges = []  # (name, start, end) host ranges (`record_function`)
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev["dur"]) * 1e-6
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                self.ops.append((ev.get("name", ""), s, e, ev.get("args", {}).get("stream")))
            elif cat == "user_annotation":
                self.ranges.append((ev.get("name", ""), s, e))
        frames = [r for r in self.ranges if r[0] == FRAME_RANGE]
        ends = [e for _, _, e, _ in self.ops] + [e for _, _, e in frames]
        if frames:
            self.start = min(s for _, s, _ in frames)
            self.end = max(ends)
        elif self.ops:
            self.start = min(s for _, s, _, _ in self.ops)
            self.end = max(ends)
        else:
            self.start = self.end = 0.0
        self.busy = union([(max(s, self.start), min(e, self.end)) for _, s, e, _ in self.ops
                           if e > self.start and s < self.end])

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernels(self, names: Sequence[str]) -> List[Tuple[float, float]]:
        """(start, end) of each device operation whose name holds one of
        `names`."""
        return [(s, e) for n, s, e, _ in self.ops if any(k in n for k in names)]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost host range open at `t` (the shortest that holds it)."""
        best = None
        for n, s, e in self.ranges:
            if s <= t < e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "(no host range)"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for name, s, e, _ in self.ops:
            by_op[name] += e - s
        by_host: Dict[str, float] = collections.defaultdict(float)
        for s, e in self.idle_gaps():
            by_host[self.host_at(0.5 * (s + e))] += e - s
        top = lambda d: [[k[:NAME_CHARS], v]  # noqa: E731
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


class Tracer:
    """Runs the profiler, the sync count and the launch counts over the
    span; fills the run's `Ctx` (`trace`, `span_s`, `syncs`, `launches`)."""

    def __init__(self, ctx, on_card: bool):
        self.ctx = ctx
        self.on_card = on_card
        self.running = False
        self.done = False
        self.prof = None

    def at_frame(self, elapsed: float, cfg: dict, caught: list) -> None:
        if self.done:
            return
        if not self.running and elapsed >= float(cfg["start_s"]):
            self.start(caught)
        elif self.running and time.perf_counter() - self.t_start >= float(cfg["span_s"]):
            self.stop(caught)

    def start(self, caught: list) -> None:
        import torch
        from densemonoslam_tpu_torch.utils import graphs, launches

        graphs.settle_counts()
        self.counts0 = collections.Counter(launches.COUNTS)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.n_caught = len(caught)
        if self.on_card:
            torch.cuda.set_sync_debug_mode("warn")
        self.t_start = time.perf_counter()
        self.running = True
        self.ctx.in_span = self.ctx.traced = True

    def stop(self, caught: list) -> None:
        if not self.running:
            return
        import torch
        from densemonoslam_tpu_torch.utils import graphs, launches

        if self.on_card:
            torch.cuda.set_sync_debug_mode(0)
        self.ctx.syncs = sum(1 for w in caught[self.n_caught:]
                             if "synchroniz" in str(w.message))
        if self.on_card:
            torch.cuda.synchronize()
        self.ctx.span_s = time.perf_counter() - self.t_start
        self.prof.stop()
        graphs.settle_counts()
        self.ctx.launches = collections.Counter(launches.COUNTS)
        self.ctx.launches.subtract(self.counts0)
        self.running = False
        self.done = True
        self.ctx.in_span = False

    def finish(self) -> None:
        """Read the span's trace into `ctx.trace` (a Chrome trace written to
        and read back from a temporary file, then deleted)."""
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.ctx.trace = Trace(events)
        self.prof = None
