"""Timing on the host and on the card: the operator's section stopwatch, the
span recorder, and stage stamps inside captured programs.

`Stopwatch` is the port of `densemonoslam_tpu.utils.timer`: the reference's
`Stopwatch.h` TICK/TOCK singleton streams timings over UDP to
StopwatchViewer and dumps a CSV at session end; here it is a plain object
with context-manager sections and CSV export.  CUDA work is asynchronous, so
a section that should include device time passes the tensors to wait for
(`block=`): the clock stops after their devices are synchronised (nothing to
wait for on the CPU).

**Spans.** `span(name, device=False)` marks a stage of the program on the
host.  It always opens a `torch.profiler` range of that name (free when no
profiler runs).  While the process-wide recorder is on (`enable()`; off by
default) it also appends one record (`Span`): the name, the frame id (the
engine's session tick, set by `set_frame` when a frame starts), the index
of the enclosing span, and its start and end from `time.perf_counter_ns()`,
which is CLOCK_MONOTONIC in nanoseconds.  With `device=True` the record
also holds a pair of timing CUDA events recorded on the current stream and
never waited on; `device_ms(record)` reads them once the run is over.
Opening a recorded device span under graph capture raises.  The records
stay in memory, at most `CAPACITY` of them (later spans go unrecorded):
`spans()` returns them and `reset()` clears them.  The recorder serves one
thread, the one that drives the engine.  Under a running profiler each span
is also a `user_annotation` event of the Chrome trace, whose clock is this
one plus a constant offset (`PERF.md` §3), so a trace's device operations
and idle gaps fall to the innermost span.

**Stage stamps.** `StageRing` holds, per frame, the device time at which
each stage of a program began or ended: `stamp(slot, tick)` launches a
one-thread kernel (`csrc/stamp.cu`) that writes `%globaltimer` and the
frame's tick (a device scalar) into a ring of `RING_FRAMES` frames.  A
kernel can be captured into a CUDA graph, also inside a conditional node's
body, where an event cannot; a stage that did not run leaves its slot
tagged with an older tick.  On the CPU, `stamp` writes
`time.perf_counter_ns()` into the same ring with tensor operations (no
host read).  `read()` copies the ring to the host once; `intervals(a, b)`
gives, by tick, each frame's time from stamp `a` to stamp `b`, for the
frames that took both.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import socket
import struct
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from densemonoslam_tpu_torch.utils import launches

CAPACITY = 1 << 18  # records kept by the span recorder
RING_FRAMES = 4096  # frames a `StageRing` holds

_ON = False
_FRAME = -1
_RECORDS: List["Span"] = []
_OPEN: List[int] = []  # indices of the recorded spans now open, innermost last


def _synchronize(block) -> None:
    """Wait for the CUDA devices of every tensor in `block` (a tensor or a
    nested list/tuple/dict of them)."""
    devices = set()

    def visit(x) -> None:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(block)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Stopwatch:
    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = defaultdict(list)
        self._udp: Optional[socket.socket] = None
        self._udp_addr = ("127.0.0.1", 45454)
        self._udp_interval = 10.0
        self._udp_last = 0.0

    # --- StopwatchViewer-style UDP streaming --------------------------------
    def enable_udp(
        self, host: str = "127.0.0.1", port: int = 45454, interval_s: float = 10.0
    ) -> None:
        """Stream the latest timings over UDP in the reference's
        `Stopwatch::sendAll` packet (every 10 s to 127.0.0.1:45454): the total
        byte count (i32) followed by [name\\0 + f32 latest-ms] records."""
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp_addr = (host, port)
        self._udp_interval = interval_s
        self._udp_last = 0.0

    def _maybe_send(self) -> None:
        if self._udp is None:
            return
        now = time.monotonic()
        if now - self._udp_last < self._udp_interval:
            return
        self._udp_last = now
        body = b""
        for name, vals in self.timings.items():
            if vals:
                body += name.encode() + b"\x00" + struct.pack("<f", vals[-1])
        packet = struct.pack("<i", len(body) + 4) + body
        try:
            self._udp.sendto(packet, self._udp_addr)
        except OSError:
            pass

    @contextlib.contextmanager
    def section(self, name: str, block=None):
        """Time a named section in milliseconds; with `block`, wait for its
        tensors' devices before stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                _synchronize(block)
            self.timings[name].append((time.perf_counter() - t0) * 1e3)

    def tick(self, name: str) -> float:
        """The clock (`time.perf_counter()`), to hand to `tock`.  `name` is
        not read: it names the section at the call site, as the reference's
        `TICK(name)` does, and `tock` records under its own `name`."""
        return time.perf_counter()

    def tock(self, name: str, t0: float, block=None) -> None:
        if block is not None:
            _synchronize(block)
        self.timings[name].append((time.perf_counter() - t0) * 1e3)
        self._maybe_send()

    def mean(self, name: str) -> float:
        vals = self.timings.get(name, [])
        return sum(vals) / len(vals) if vals else 0.0

    def last(self, name: str) -> float:
        vals = self.timings.get(name, [])
        return vals[-1] if vals else 0.0

    def write_csv(self, path: str, names: Optional[List[str]] = None) -> None:
        """One column per section, one row per sample, ragged columns padded
        with empty cells (the reference's `.timings.csv`)."""
        names = names or sorted(self.timings)
        rows = max((len(self.timings[n]) for n in names), default=0)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(names)
            for i in range(rows):
                w.writerow(
                    [
                        f"{self.timings[n][i]:.4f}" if i < len(self.timings[n]) else ""
                        for n in names
                    ]
                )

    def summary(self) -> Dict[str, float]:
        return {n: self.mean(n) for n in self.timings}


# ------------------------------------------------------------------ spans
class Span:
    """One recorded span: times in `time.perf_counter_ns()` nanoseconds;
    `parent` is the index of the enclosing recorded span (-1 at the root);
    `events` the (start, end) timing CUDA events of a device span."""

    __slots__ = ("name", "frame", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, frame: int, parent: int, start_ns: int, events):
        self.name, self.frame, self.parent = name, frame, parent
        self.start_ns, self.end_ns, self.events = start_ns, start_ns, events

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, frame={self.frame}, parent={self.parent}, "
                f"ms={self.ms:.4f})")


class _Open:
    __slots__ = ("_name", "_device", "_range", "_rec", "_idx")

    def __init__(self, name: str, device: bool):
        self._name, self._device, self._rec = name, device, None

    def __enter__(self):
        record = _ON and len(_RECORDS) < CAPACITY
        if record and self._device and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device span {self._name!r} opened under graph capture")
        self._range = record_function(self._name)
        self._range.__enter__()
        # the range holds the record: its clock reads come just inside the
        # range's own enter and exit
        if record:
            events = None
            if self._device:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            self._idx = len(_RECORDS)
            self._rec = Span(self._name, _FRAME, _OPEN[-1] if _OPEN else -1,
                             time.perf_counter_ns(), events)
            _RECORDS.append(self._rec)
            _OPEN.append(self._idx)
        return self

    def __exit__(self, *exc) -> bool:
        rec = self._rec
        if rec is not None:
            rec.end_ns = time.perf_counter_ns()
            if rec.events is not None:
                rec.events[1].record()
            if _OPEN and _OPEN[-1] == self._idx:
                _OPEN.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, device: bool = False) -> _Open:
    """A context manager: the profiler range `name`, and while the recorder
    is on, a `Span` record (with `device=True`, timing CUDA events too; the
    caller passes it only where the work runs on a CUDA stream)."""
    return _Open(name, device)


def enable(on: bool = True) -> None:
    """Turn the span recorder on (or off)."""
    global _ON
    _ON = on


def enabled() -> bool:
    return _ON


def set_frame(frame: int) -> None:
    """The frame id that spans opened from now on carry."""
    global _FRAME
    _FRAME = frame


def spans() -> List[Span]:
    """The recorded spans, in the order they were opened."""
    return list(_RECORDS)


def reset() -> None:
    """Clear the records (spans open now go unrecorded when they close)."""
    _RECORDS.clear()
    _OPEN.clear()


def device_ms(rec: Span) -> Optional[float]:
    """Device milliseconds between a device span's events (waits for its
    end event), or None for a host-only span."""
    if rec.events is None:
        return None
    start, end = rec.events
    end.synchronize()
    return start.elapsed_time(end)


# ----------------------------------------------------------- stage stamps
def _declare_stamp(lib: ctypes.CDLL) -> None:
    lib.stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.stamp.restype = ctypes.c_int


def _stamp_lib() -> ctypes.CDLL:
    from densemonoslam_tpu_torch.ops import cuda_build

    return cuda_build.load("stamp", _declare_stamp)


class StageRing:
    """Per-frame stamps of a program's stages (see the module docstring):
    an int64 ring [RING_FRAMES, slots, 2] of (time ns, tick), -1 where
    nothing was stamped, on the device of the first tick it is given."""

    def __init__(self, slots: int):
        self.slots = slots
        self.ring: Optional[torch.Tensor] = None

    def allocate(self, device: torch.device) -> None:
        """The ring on `device` (a new, empty one if it was elsewhere)."""
        device = torch.device(device)
        if self.ring is None or self.ring.device != device:
            self.ring = torch.full((RING_FRAMES, self.slots, 2), -1, dtype=torch.int64,
                                   device=device)

    def stamp(self, slot: int, tick: torch.Tensor) -> None:
        """Stamp stage `slot` for the frame whose tick the int64 0-dim
        `tick` holds; on the card, when the stream's work reaches it."""
        if tick.dtype != torch.int64 or tick.numel() != 1:
            raise ValueError(f"a stamp's tick is one int64, not {tick.dtype} {tuple(tick.shape)}")
        self.allocate(tick.device)
        if tick.device.type == "cuda":
            err = _stamp_lib().stamp(torch.cuda.current_stream(tick.device).cuda_stream,
                                     self.ring.data_ptr(), tick.data_ptr(), slot, self.slots,
                                     RING_FRAMES)
            if err != 0:
                raise RuntimeError(f"stage stamp launch failed (cudaError {err})")
            launches.add("stamp")
            return
        k = tick.reshape(()).to(torch.int64)
        now = torch.full((), time.perf_counter_ns(), dtype=torch.int64)
        self.ring.view(-1, 2).index_copy_(0, ((k % RING_FRAMES) * self.slots + slot).reshape(1),
                                          torch.stack([now, k]).reshape(1, 2))

    def read(self) -> Optional[np.ndarray]:
        """The ring on the host (one copy), or None before the first stamp."""
        return None if self.ring is None else self.ring.cpu().numpy()

    def intervals(self, a: int, b: int, stamps: Optional[np.ndarray] = None
                  ) -> List[Tuple[int, float]]:
        """(tick, ms from stamp `a` to stamp `b`) of each frame in the ring
        that took both, by tick, from `stamps` (a `read()`, taken now if not
        given).  A slot tagged with another tick than the frame's is a stage
        that did not run in that frame, and is not read."""
        if stamps is None:
            stamps = self.read()
        if stamps is None:
            return []
        t, tag = stamps[..., 0], stamps[..., 1]
        ran = (tag[:, a] >= 0) & (tag[:, b] == tag[:, a])
        rows = np.flatnonzero(ran)
        rows = rows[np.argsort(tag[rows, a], kind="stable")]
        return [(int(tag[r, a]), float(t[r, b] - t[r, a]) * 1e-6) for r in rows]
