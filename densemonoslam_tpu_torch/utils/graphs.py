"""Compiled programs on the card: CUDA graphs with on-device branches (the
port's counterpart of `jax.jit` and `lax.cond`).

`GraphedFn(fn)` runs `fn` as one captured CUDA graph: the first call warms
`fn` up on a side stream and captures it into a private memory pool; every
call copies its inputs into the graph's static input buffers and replays
the graph.  Inputs listed in `donate` are taken by address, as the JAX
package's `donate_argnums`: `fn` updates them in place, and a tensor that
replaced one of them from outside is copied in (one copy, counted in
`STATE_COPIES`).

`branch(pred, body, name)` is `lax.cond` whose false side keeps its
operands: `body` writes its results into tensors that exist before the
call, and the false side leaves them as they were.  Under capture the body
goes under a CUDA conditional IF node on the device bool `pred`
(`csrc/graph_if.cu`: PyTorch 2.11's `CUDAGraph` does not bind them),
captured on a stream of its own with its temporaries in a memory pool of
the graph's; during the warm-up before a capture the body runs
whatever `pred` holds, on that same stream (the false side does nothing),
so everything it initialises is initialised before the capture; otherwise
it is a Python `if`, whose read of `pred` is the one host read of an eager
program (a `utils.timer` span `host.read`).

A capture (warm-up included) is the `utils.timer` span `step.capture`,
keyed by the frame it happens in: a camera's step captures at its first
frame, and again at its next one after a merge moved its map.

Counters: `CAPTURES`, `REPLAYS`, `STATE_COPIES`, and `BRANCH_RUNS` (body
runs per branch name).  A replay adds the kernel launches its capture
recorded to `utils.launches`; the launches inside a branch body count only
for the replays in which it ran, which only the device knows: each body
adds one to a device counter, and `settle_counts()` reads them (a host
read) and adds what they owe, also for graphs dropped since the last
settle.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from densemonoslam_tpu_torch.utils import launches, timer

CAPTURES = 0
REPLAYS = 0
STATE_COPIES = 0
BRANCH_RUNS: Counter = Counter()

_MAX_BRANCHES = 64  # IF nodes per graph (one device counter slot each)
_ACTIVE: Optional["_Recording"] = None  # the warm-up or capture under way
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}
_BODY_STREAMS: Dict[Tuple[int, int], torch.cuda.Stream] = {}  # (device, depth)


def _add_counts(delta: Counter, times: int) -> None:
    for key, n in delta.items():
        launches.COUNTS[key] += n * times


def _diff(after: Counter, before: Counter) -> Counter:
    return Counter({k: after[k] - before[k] for k in after if after[k] != before[k]})


class _Tally:
    """A captured graph's branch bodies: the device counter of their runs
    and the launches each adds per run.  It outlives its graph until the
    next `settle_counts`, so that no body run is lost when a graph is
    dropped."""

    def __init__(self, runs: torch.Tensor, names: List[str], own: List[Counter]):
        self.runs, self.names, self.own = runs, names, own
        self.settled = [0] * len(names)
        self.dropped = False

    def settle(self) -> None:
        ran = self.runs[: len(self.own)].tolist()
        for slot, n in enumerate(ran):
            BRANCH_RUNS[self.names[slot]] += n - self.settled[slot]
            _add_counts(self.own[slot], n - self.settled[slot])
            self.settled[slot] = n


_TALLIES: List[_Tally] = []


def _drop(tally: _Tally) -> None:
    tally.dropped = True


class _Recording:
    """What `branch` needs while a `GraphedFn` warms up or captures."""

    def __init__(self, mode: str, runs: Optional[torch.Tensor] = None, body_pool=None):
        self.mode = mode  # "warmup" or "capture"
        self.body_pool = body_pool  # where branch bodies allocate under capture
        self.runs = runs  # [_MAX_BRANCHES] int64 device counter, one slot per IF node
        self.names: List[str] = []
        self.parents: List[Optional[int]] = []
        self.totals: List[Counter] = []  # launches captured inside each body, nested ones too
        self.stack: List[int] = []


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every warm-up and capture on `device` runs on."""
    idx = _index(device)
    if idx not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _CAPTURE_STREAMS[idx]


def _body_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream branch bodies nested `depth` deep run and capture on."""
    key = (_index(device), depth)
    if key not in _BODY_STREAMS:
        _BODY_STREAMS[key] = torch.cuda.Stream(device=key[0])
    return _BODY_STREAMS[key]


def _declare_if(lib: ctypes.CDLL) -> None:
    lib.graph_if_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.graph_if_begin.restype = ctypes.c_int
    lib.graph_if_end.argtypes = [ctypes.c_void_p]
    lib.graph_if_end.restype = ctypes.c_int


def _if_lib() -> ctypes.CDLL:
    from densemonoslam_tpu_torch.ops import cuda_build

    return cuda_build.load("graph_if", _declare_if)


@contextlib.contextmanager
def _warm_body(device: torch.device, depth: int):
    """Run a body on its stream, ordered with the work around it."""
    cur = torch.cuda.current_stream(device)
    body = _body_stream(device, depth)
    body.wait_stream(cur)
    with torch.cuda.stream(body):
        yield
    cur.wait_stream(body)


def scratch_stream(device: torch.device, current: int) -> int:
    """The stream whose scratch a kernel launched on raw stream `current`
    uses.  Inside a capture, branch bodies are captured on child streams of
    the capture stream; the graph runs their nodes in order with the rest,
    so they share the capture stream's scratch, which the warm-up
    allocated."""
    if _ACTIVE is not None and _ACTIVE.mode == "capture":
        return capture_stream(device).cuda_stream
    return current


def branch(pred: torch.Tensor, body: Callable[[], None], name: str) -> None:
    """Run `body` where the 0-dim device bool `pred` holds (see the module
    docstring).  `body` returns nothing: it writes into existing tensors."""
    rec = _ACTIVE
    if rec is None:
        with timer.span("host.read"):
            taken = bool(pred)
        if taken:
            BRANCH_RUNS[name] += 1
            body()
        return
    depth = len(rec.stack)
    if rec.mode == "warmup":
        rec.stack.append(-1)
        try:
            with _warm_body(pred.device, depth):
                body()
        finally:
            rec.stack.pop()
        return
    slot = len(rec.names)
    if slot >= _MAX_BRANCHES:
        raise RuntimeError(f"more than {_MAX_BRANCHES} branches in one graph")
    rec.names.append(name)
    rec.parents.append(rec.stack[-1] if rec.stack else None)
    rec.totals.append(Counter())
    flag = pred.reshape(()).to(torch.bool)
    lib = _if_lib()
    stream = _body_stream(pred.device, depth)
    err = lib.graph_if_begin(torch.cuda.current_stream(pred.device).cuda_stream,
                             flag.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"branch {name}: adding its IF node failed (cudaError {err})")
    launches.add("graph_if")  # the setter runs where the enclosing part of the graph runs
    before = Counter(launches.COUNTS)
    rec.stack.append(slot)
    try:
        # this thread allocates into the body pool from the outermost body on
        pool = (torch.cuda.memory.use_mem_pool(rec.body_pool, pred.device) if depth == 0
                else contextlib.nullcontext())
        with torch.cuda.stream(stream), pool:
            rec.runs[slot].add_(1)
            body()
    finally:
        rec.stack.pop()
        err = lib.graph_if_end(stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"branch {name}: ending its body's capture failed (cudaError {err})")
    rec.totals[slot] = _diff(launches.COUNTS, before)


def copy_state(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a tensor that replaced a graph's state buffer from outside into
    the buffer (counted in `STATE_COPIES`)."""
    global STATE_COPIES
    dst.copy_(src)
    STATE_COPIES += 1


def assign(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """Copy each of `srcs` into the tensor at its place in `dsts`: how a
    branch body hands out its results.  Shapes and dtypes must match, so
    both sides of a branch leave its outputs alike."""
    if len(dsts) != len(srcs):
        raise ValueError(f"{len(srcs)} results for {len(dsts)} outputs")
    for d, s in zip(dsts, srcs):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(
                f"branch output {d.dtype} {tuple(d.shape)} given {s.dtype} {tuple(s.shape)}"
            )
        d.copy_(s)


class GraphedFn:
    """`fn(*args)` as one CUDA graph; `fn` returns a tensor or a tuple of
    tensors, which live in the graph's pool: the next replay overwrites
    them, so a caller clones what it keeps.

    `args` are CUDA tensors or Python numbers (a number, or a 0-dim tensor
    given later, fills a 0-dim buffer); every call must give each tensor
    argument its capture's shape and dtype.  A tensor on another device
    raises `ValueError`: nothing here runs eagerly."""

    def __init__(self, fn: Callable, donate: Sequence[int] = ()):
        self.fn = fn
        self.donate = frozenset(donate)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: List[torch.Tensor] = []
        self.outputs = None
        self.capture_seconds = 0.0
        self._launches = Counter()  # launches of one replay outside every branch body

    def __call__(self, *args):
        global REPLAYS
        for a in args:
            if isinstance(a, torch.Tensor) and a.device.type != "cuda":
                raise ValueError(
                    f"GraphedFn runs CUDA graphs only; got a tensor on {a.device}"
                )
        if self.graph is None:
            with timer.span("step.capture"):
                self._capture(args)
        else:
            self._copy_in(args)
        self.graph.replay()
        REPLAYS += 1
        _add_counts(self._launches, 1)
        return self.outputs

    # ------------------------------------------------------------ inputs
    def _static(self, i: int, a, seen: set) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            dtype = (torch.bool if isinstance(a, bool) else
                     torch.int64 if isinstance(a, int) else torch.float32)
            return torch.full((), a, dtype=dtype, device=self._device)
        ptr = a.untyped_storage().data_ptr()
        if i in self.donate and ptr not in seen:
            seen.add(ptr)
            return a
        seen.add(ptr)
        return a.clone(memory_format=torch.contiguous_format)

    def _copy_in(self, args) -> None:
        if len(args) != len(self.inputs):
            raise ValueError(f"{len(args)} arguments for a graph of {len(self.inputs)}")
        for i, (a, s) in enumerate(zip(args, self.inputs)):
            if not isinstance(a, torch.Tensor):
                s.fill_(a)
                continue
            if a is s or (a.data_ptr() == s.data_ptr() and a.shape == s.shape
                          and a.stride() == s.stride() and a.dtype == s.dtype):
                continue
            if s.dim() == 0 and a.numel() == 1:
                (copy_state if i in self.donate else torch.Tensor.copy_)(s, a.reshape(()))
            elif a.shape != s.shape or a.dtype != s.dtype:
                raise ValueError(
                    f"argument {i}: {a.dtype} {tuple(a.shape)}, captured as "
                    f"{s.dtype} {tuple(s.shape)}"
                )
            elif i in self.donate:
                copy_state(s, a)
            else:
                s.copy_(a)

    # ----------------------------------------------------------- capture
    def _capture(self, args) -> None:
        global _ACTIVE, CAPTURES
        import time

        t0 = time.perf_counter()
        self._device = next(a.device for a in args if isinstance(a, torch.Tensor))
        seen: set = set()
        self.inputs = [self._static(i, a, seen) for i, a in enumerate(args)]
        stream = capture_stream(self._device)
        _if_lib()  # built and loaded before the capture
        stream.wait_stream(torch.cuda.current_stream(self._device))
        # warm-up on copies, so the caller's state is untouched: every
        # branch body runs once, and with it every lazy initialisation
        # (cuBLAS handles, kernel builds, each kernel's scratch for the
        # capture stream)
        with torch.cuda.stream(stream):
            warm = [x.clone() for x in self.inputs]
            _ACTIVE = _Recording("warmup")
            try:
                self.fn(*warm)
            finally:
                _ACTIVE = None
            del warm
        torch.cuda.current_stream(self._device).wait_stream(stream)
        runs = torch.zeros(_MAX_BRANCHES, dtype=torch.int64, device=self._device)
        graph = torch.cuda.CUDAGraph()
        self._body_pool = torch.cuda.MemPool()
        rec = _Recording("capture", runs, self._body_pool)
        before = Counter(launches.COUNTS)
        _ACTIVE = rec
        try:
            # a capture that fails raises, and leaves no graph to replay
            with torch.cuda.graph(graph, stream=stream):
                outputs = self.fn(*self.inputs)
        finally:
            _ACTIVE = None
            # the capture launched nothing: take its counts back
            total = _diff(launches.COUNTS, before)
            _add_counts(Counter({k: -v for k, v in total.items()}), 1)
        self.graph, self.outputs = graph, outputs
        # the counts per part of the graph, for the replays
        own = [Counter(t) for t in rec.totals]
        for slot, parent in enumerate(rec.parents):
            target = own[parent] if parent is not None else total
            target.subtract(rec.totals[slot])
        self._launches = +total
        if rec.names:
            tally = _Tally(runs, rec.names, [+o for o in own])
            _TALLIES.append(tally)
            weakref.finalize(self, _drop, tally)
        CAPTURES += 1
        self.capture_seconds = time.perf_counter() - t0


def settle_counts() -> None:
    """Bring `BRANCH_RUNS` and the kernels' launch counts up to date with
    every replay so far (one host read per graph that has branches, or had
    them and was dropped since the last settle)."""
    for tally in list(_TALLIES):
        tally.settle()
    _TALLIES[:] = [t for t in _TALLIES if not t.dropped]
