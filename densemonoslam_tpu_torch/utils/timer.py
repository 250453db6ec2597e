"""Named-section wall-clock profiler (port of `densemonoslam_tpu.utils.timer`).

The reference's `Stopwatch.h` TICK/TOCK singleton streams timings over UDP
to StopwatchViewer and dumps a CSV at session end; here it is a plain object
with context-manager sections and CSV export.  CUDA work is asynchronous, so
a section that should include device time passes the tensors to wait for
(`block=`): the clock stops after their devices are synchronised (nothing to
wait for on the CPU).
"""

from __future__ import annotations

import contextlib
import csv
import socket
import struct
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


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
