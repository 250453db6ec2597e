#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`benchmark/workloads/<cell>.json`) names a configuration
(`benchmark/configs/<config>.json`: camera, `EngineConfig` fields, tracker,
depth net) and a traffic mix (parameters that `traffic/frames.py` reads).
The run renders the cell's frames from the seed, builds the port's
`Engine` with one frontend a camera (the configuration's ``"cameras"``,
default 1: ``cam0``, ``cam1``, ...), hands it the warm-up frames (set-up),
then hands it frames for `--seconds`, back to back or on the traffic's
schedule, each as host numpy arrays through `Engine.process_frame` (the
upload is inside the window).  A tick hands over one frame of every
camera that has joined, in camera order.  Afterwards the run
holds what the program produced against the plain reference under
`benchmark/reference/` (`correct`): each check the cell names is a
`benchmark/checks/<check>.py`, its limits are the cell's ``"limits"``.
`--control 1` also reads the control (the reference in TF32 in the
program's place) and judges it by the same limits: the result then holds
``control_correct`` and ``control_checks`` too.

`--trace 0` reports the cell's end-to-end metrics (`fps`, `frame_ms_p95`,
`peak_mem_mib`, `setup_s`); `--trace 1` runs the same window with
`torch.profiler` over a span of whole frames chosen by time (the cell's
``"trace"``), the sync debug mode on and each per-layer metric's probes,
and reports the per-layer metrics, each read by its own
`benchmark/metrics/<metric>.py`.  The last line of standard output is one
JSON object; the numbers compared for `correct` and their limits are the
last lines of standard error and the result's last key, ``checks``.

The run needs a CUDA card and fails without one; it never falls back to
the CPU.  Kernel builds go to the checkout's `build/` (the port's
`build/kernels/`, and `TORCH_EXTENSIONS_DIR` and `TRITON_CACHE_DIR` under
`build/`), so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import warnings  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "densemonoslam_tpu")
MiB = float(1 << 20)
POSE = slice(13, 29)  # the stats row's tracked pose, row-major 4x4
BLOCK_ROWS = 1 << 20  # map rows read at a time: a block's temporaries set no memory peak


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def _cache_dirs() -> None:
    """Every kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quantile(values, q: int, n: int = 100) -> float:
    """The `q`-th of `n` quantiles (`statistics.quantiles`, exclusive)."""
    if len(values) < 2:
        return float(values[0]) if values else math.nan
    return statistics.quantiles(values, n=n)[q - 1]


class Spec:
    """A cell as the files under `benchmark/` and `BENCHMARK.json` give it."""

    def __init__(self, workload: str, bench_dir: str = BENCH):
        self.bench_dir = bench_dir
        self.benchmark = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
        self.cell = load_json(os.path.join(bench_dir, "workloads", f"{workload}.json"))
        self.name = workload
        self.config = load_json(os.path.join(bench_dir, "configs", f"{self.cell['config']}.json"))
        entry = [w for w in self.benchmark["workloads"] if w["name"] == workload]
        self.chips = int(entry[0]["chips"]) if entry else 1
        self.end_to_end = [m for m in self.benchmark["end_to_end"] if self._in_cell(m)]
        self.per_layer = [m for m in self.benchmark["per_layer"] if self._in_cell(m)]

    def _in_cell(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def check(self, name: str, ctx, params: dict):
        mod = load_module(os.path.join(self.bench_dir, "checks", f"{name}.py"),
                          f"bench_check_{name.replace('.', '_')}")
        return mod.Check(ctx, params)

    def reader(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics", f"{name}.py"),
                           f"bench_metric_{name.replace('.', '_')}")


class Ctx:
    """What a per-layer metric's `install` and `read` and a check see: the
    engine and cameras under test, the run's seed, configuration and
    traffic, the window's frames, the trace of the traced span, its
    counters, and a dict for the metric's own probes.  `frontend` and
    `traffic` are the first camera's (``cam0``); `frontends` and
    `traffics` give every camera's by name, in camera order."""

    def __init__(self, spec, engine, frontends: dict, device, seed: int, traffics: dict):
        import torch

        self.spec = spec
        self.config = spec.config
        self.engine = engine
        self.frontends = frontends  # name -> Frontend
        self.frontend = next(iter(frontends.values()))
        self.device = device
        self.on_card = device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.on_card else (lambda: None)
        self.seed = seed
        self.traffics = traffics  # name -> traffic.frames.Traffic
        self.traffic = next(iter(traffics.values()))
        self.probes: dict = {}
        self.in_window = False
        self.in_span = False
        self.traced = False  # the profiler has run in this window: its cost outlasts its span
        self.trace = None  # tracing.Trace of the traced span
        self.span_frames = 0
        self.span_s = 0.0
        self.pre_span_frames = None  # window frames handed over before the traced span
        self.pre_span_s = 0.0  # and the window's seconds before it
        self.syncs = 0
        self.launches = collections.Counter()  # (kernel, shape) over the span
        self.window_frames = 0
        self.seconds = 0.0  # the window's length, as asked
        self.t_window = 0.0  # seconds into the window of the frame being handed over
        self.probing = False  # a check copies the program's state in this frame or call
        # on a schedule: (due, handed over) seconds into the window of each
        # window frame before the traced span that no check copies
        self.handovers: list = []
        self.log = log


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def build_engine(spec: Spec, traffics: list, device):
    """The port's engine for the cell's configuration and its frontends by
    name: camera k is ``cam{k}``, in its own map, at its traffic's first
    ground-truth pose.  All cameras share the configuration's camera."""
    import numpy as np

    from densemonoslam_tpu_torch.config import (
        CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
    )
    from densemonoslam_tpu_torch.engine import Engine

    c = spec.config["camera"]
    camera = CameraConfig(FrameResolution(int(c["width"]), int(c["height"])),
                          CameraIntrinsics(float(c["fx"]), float(c["fy"]),
                                           float(c["cx"]), float(c["cy"])), "bench")
    eng = Engine(camera, EngineConfig(**spec.config["engine"]), device=device)
    frontends = {}
    for k, traffic in enumerate(traffics):
        fe = eng.frontend(f"cam{k}")
        fe.pose = traffic.gt_pose(0).astype(np.float32)
        frontends[fe.name] = fe
    net = spec.config.get("depth_net")
    if net:
        from densemonoslam_tpu_torch.models.depthnet import DepthPredictor

        eng.set_depth_predictor(getattr(DepthPredictor, f"pretrained_{net}")(device=device))
    tracker = spec.config.get("tracker")
    if tracker is not None:
        from densemonoslam_tpu_torch.tracking.sparse import SparseTracker

        for fe in frontends.values():
            fe.sparse_tracker = SparseTracker(camera.intrinsics, device=device, **tracker)
            fe.sparse_tracker.pose = fe.pose
    return eng, frontends


def time_step(ctx) -> None:
    """CUDA events just before and after each window frame's step (every
    camera's `step_fn`, the graph replay), before the traced span (the
    profiler's cost outlasts the span), into ``ctx.probes["step_events"]``:
    two event records a frame, no wait.  A step that `Engine._recompile`
    replaces (a merge that changes a camera's map) is wrapped again."""
    import torch

    pairs = ctx.probes.setdefault("step_events", [])

    def wrap(fe) -> None:
        inner = fe.step_fn

        def timed(*a, **k):
            if not ctx.in_window or ctx.traced:
                return inner(*a, **k)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = inner(*a, **k)
            e.record()
            pairs.append((s, e))
            return out

        fe.step_fn = timed

    for fe in ctx.frontends.values():
        wrap(fe)
    eng = ctx.engine
    recompile = eng._recompile

    def recompile_and_wrap(fe) -> None:
        recompile(fe)
        wrap(fe)

    eng._recompile = recompile_and_wrap


def map_rows(eng, name: str) -> tuple:
    """(rows below the count, live rows last seen within `time_delta` ticks
    of the session tick: the active set) of camera `name`'s map, read in
    blocks of `BLOCK_ROWS`."""
    from reference import surfel_map as rsm

    be = eng.backend_of(name)
    count, t_now, active = int(be.map_count), float(eng.global_tick), 0
    for s in range(0, count, BLOCK_ROWS):
        rows = be.map_data[s:min(s + BLOCK_ROWS, count)]
        live = (rows[:, rsm.CONF] > 0) & (t_now - rsm.last_seen_any(rows) < eng.config.time_delta)
        active += int(live.sum())
    return count, active


def prewarm(eng, device) -> None:
    """What the cell's frames would otherwise first use inside the window:
    every kernel of the port built (`ops.cuda_build`, all at once) and, with
    loop closure on, the local loop's Gauss-Newton/CG program captured at
    the shapes `loops.try_local_loop` gives it (the graph's node count, the
    constraint grid of the frame, the carried constraints' ring)."""
    import torch
    from densemonoslam_tpu_torch import loops
    from densemonoslam_tpu_torch.mapping import deformation as dg
    from densemonoslam_tpu_torch.ops import cuda_build, warp

    if device.type == "cuda":
        cuda_build.build(*sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
    cfg = eng.config
    if cfg.open_loop:
        return
    res = eng.camera.resolution
    n = warp.decimate(torch.zeros((res.height, res.width), device=device),
                      cfg.loop_constraint_stride).numel()
    f32 = dict(dtype=torch.float32, device=device)
    cons = dg.Constraint(src=torch.zeros((2 * n, 3), **f32), dst=torch.zeros((2 * n, 3), **f32),
                         time=torch.zeros((2 * n,), **f32),
                         valid=torch.zeros((2 * n,), dtype=torch.bool, device=device),
                         pinned=torch.zeros((2 * n,), dtype=torch.bool, device=device))
    graph = dg.empty_graph(cfg.max_deform_nodes, device)
    dg.optimise_graphed(graph, cons, frozen=torch.zeros_like(graph.valid),
                        rel=loops.make_rel_bank(device=device).cons)


def judge(readings: dict, limits: dict) -> tuple:
    """Each reading beside its limit, and whether every one is within it
    (a reading without a limit, one that is not a finite number, shown as
    null, or no reading at all, is not)."""
    results = {k: {"value": float(v) if math.isfinite(v) else None, "limit": limits.get(k)}
               for k, v in readings.items()}
    ok = bool(results) and all(r["limit"] is not None and r["value"] is not None
                               and r["value"] <= r["limit"] for r in results.values())
    return results, ok


def main(argv=None, device: str | None = None) -> int:
    """One run; returns the exit code.  `device` other than None skips the
    look for a card and runs there (the tests drive the CPU so)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--bench-dir", default=BENCH, help=argparse.SUPPRESS)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control: the reference in TF32 in the program's place")
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    spec = Spec(args.workload, args.bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark runs on the card only")
            return 2
        if torch.cuda.device_count() < spec.chips:
            log(f"the cell needs {spec.chips} CUDA devices, {torch.cuda.device_count()} found")
            return 2
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.set_num_threads(4)
    sys.path.insert(0, spec.bench_dir)
    sys.path.insert(0, os.path.dirname(spec.bench_dir))
    from traffic import frames as framesmod

    tracemod = load_module(os.path.join(spec.bench_dir, "tracing.py"), "bench_tracing")
    if on_card:
        log(f"card (nvidia-smi name, power.limit): {_card_line()}")

    # ------------------------------------------------------------ set-up
    camera = framesmod.camera_of(spec.config)
    t_s = time.perf_counter()
    cameras = int(spec.config.get("cameras", 1))
    mix = spec.cell["traffic"]
    traffics = framesmod.make_cameras(mix, camera, cameras, device=dev)
    setup_ticks, rate_hz = int(mix["warmup_frames"]), float(mix.get("rate_hz", 0.0))
    renders = len({id(t.lap_frames) for t in traffics})
    log(f"traffic: {cameras} camera(s), {renders} lap(s) of "
        f"{'/'.join(str(len(t.lap_frames)) for t in traffics)} frames rendered in "
        f"{time.perf_counter() - t_s:.3f} s, warm-up {setup_ticks}, "
        f"rate {rate_hz or 'back to back'}")

    from densemonoslam_tpu_torch import engine as enginemod
    from densemonoslam_tpu_torch.ops import cuda_build
    from densemonoslam_tpu_torch.utils import graphs

    t_s = time.perf_counter()
    eng, fes = build_engine(spec, traffics, dev)
    prewarm(eng, dev)
    log(f"engine and pre-warm: {time.perf_counter() - t_s:.3f} s "
        f"(kernel builds {cuda_build.BUILDS}, graph captures {graphs.CAPTURES})")
    traffic_of = dict(zip(fes, traffics))
    ctx = Ctx(spec, eng, fes, dev, args.seed, traffic_of)
    ctx.seconds = args.seconds
    first = ctx.frontend.name  # the camera the checks follow
    checks = [spec.check(name, ctx, params) for name, params in spec.cell["checks"].items()]
    sent = dict.fromkeys(fes, 0)  # frames each camera has handed over

    def joined(tick: int) -> list:
        return [name for name in fes if traffic_of[name].join <= tick]

    t_s = time.perf_counter()
    for tick in range(setup_ticks):
        for name in joined(tick):
            j = sent[name]
            rgb, depth = traffic_of[name].frame(j)
            eng.process_frame(name, rgb, depth, float(j), sync=False)
            sent[name] += 1
            if name == first:
                for c in checks:
                    c.after_setup_frame(j)
    ctx.sync()
    maps0 = len(eng.maps)
    at_start = {name: (fe.loops_closed, map_rows(eng, name)) for name, fe in fes.items()}
    log(f"warm-up frames: {time.perf_counter() - t_s:.3f} s")
    readers = {}
    if args.trace:
        for m in spec.per_layer:
            readers[m["name"]] = spec.reader(m["name"])
            if hasattr(readers[m["name"]], "install"):
                readers[m["name"]].install(ctx)
    if on_card:
        time_step(ctx)
    t_s = time.perf_counter()
    for c in checks:
        c.before_window()
    log(f"checks' probes and pinned buffers: {time.perf_counter() - t_s:.3f} s")
    gc.collect()
    ctx.sync()
    builds_w, captures_w = cuda_build.BUILDS, graphs.CAPTURES
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s")

    # ------------------------------------------------------------ window
    lat = {}
    done_q: queue.Queue = queue.Queue()

    def waiter():
        while True:
            item = done_q.get()
            if item is None:
                return
            k, ev, t_hand = item
            if ev is not None:
                ev.synchronize()
            lat[k] = time.perf_counter() - t_hand

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    trace_cfg = spec.cell.get("trace", {"start_s": 0.0, "span_s": args.seconds})
    tracer = tracemod.Tracer(ctx, on_card) if args.trace else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctx.in_window = True
        ctx.sync()
        t0 = time.perf_counter()
        j = 0  # window frames handed over, every camera's
        tick = setup_ticks
        try:
            while True:
                now = time.perf_counter()
                if tracer is not None:
                    running = tracer.running
                    tracer.at_frame(now - t0, trace_cfg, caught)
                    if tracer.running != running:
                        # the window's clock stands while the profiler starts
                        # or stops (seconds, late in a window), so that the
                        # frames after the span still come
                        t0 += time.perf_counter() - now
                        now = time.perf_counter()
                    if tracer.running and ctx.pre_span_frames is None:
                        ctx.pre_span_frames, ctx.pre_span_s = j, now - t0
                if now - t0 >= args.seconds:
                    break
                if rate_hz > 0:
                    due = t0 + (tick - setup_ticks) / rate_hz
                    if now < due:
                        time.sleep(due - now)
                    t_hand = due
                else:
                    t_hand = time.perf_counter()
                ctx.t_window = now - t0
                for n, name in enumerate(joined(tick)):
                    t = traffic_of[name]
                    k = sent[name]  # the camera's run frame
                    if name == first:
                        for c in checks:
                            c.before_frame(k - t.warmup)
                    if n and rate_hz <= 0:
                        t_hand = time.perf_counter()
                    rgb, depth = t.frame(k)
                    if rate_hz > 0 and not (ctx.traced or ctx.probing):
                        ctx.handovers.append((t_hand - t0, time.perf_counter() - t0))
                    with tracemod.frame_range(tracer):
                        eng.process_frame(name, rgb, depth, float(k), sync=False)
                    ev = None
                    if on_card:
                        ev = torch.cuda.Event()
                        ev.record()
                    done_q.put((j, ev, t_hand))
                    if tracer is not None and tracer.running:
                        ctx.span_frames += 1
                    sent[name] += 1
                    j += 1
                tick += 1
            if tracer is not None:
                tracer.stop(caught)
            ctx.sync()
            t1 = time.perf_counter()
        finally:
            done_q.put(None)
            th.join(timeout=120)
            ctx.in_window = False
    n_frames = ctx.window_frames = j
    window_frames = {name: sent[name] - traffic_of[name].warmup for name in fes}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    graphs.settle_counts()
    cams = []
    for name, fe in fes.items():
        closed0, (rows0, active0) = at_start[name]
        rows1, active1 = map_rows(eng, name)
        cams.append(f"{name}: {window_frames[name]} frames, loop closures accepted "
                    f"{fe.loops_closed - closed0}, map {eng.backend_of(name).name} rows "
                    f"{rows0} -> {rows1}, active {active0} -> {active1}")
    log(f"window: {n_frames} frames in {t1 - t0:.4f} s; frame-time samples {len(lat)}; "
        f"{'; '.join(cams)}; maps {maps0} at its start, {len(eng.maps)} at its end; captures "
        f"in it {graphs.CAPTURES - captures_w}, nvcc builds in it "
        f"{cuda_build.BUILDS - builds_w}; pacing waits {enginemod.PACING_WAITS}")
    if len(lat) != n_frames:
        log(f"{n_frames - len(lat)} frames never completed")

    # ------------------------------------------------------------ metrics
    metrics = {}
    lat_ms = [1e3 * lat[k] for k in sorted(lat)]
    e2e = {
        "fps": (n_frames / (t1 - t0), "frames/s"),
        "frame_ms_p95": (quantile(lat_ms, 95), "ms"),
        "peak_mem_mib": (peak / MiB, "MiB"),
        "setup_s": (setup_s, "s"),
    }
    steps = ctx.probes.get("step_events", [])
    if steps:
        step_ms = [a.elapsed_time(b) for a, b in steps]
        log(f"step device ms over {len(step_ms)} frames: mean {statistics.fmean(step_ms):.4f}, "
            f"median {statistics.median(step_ms):.4f}")
    if lat_ms:
        log(f"frame ms over {len(lat_ms)} frames: median {statistics.median(lat_ms):.4f}, "
            f"p95 {e2e['frame_ms_p95'][0]:.4f}, max {max(lat_ms):.4f}")
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        t_read = time.perf_counter()
        tracer.finish()
        if ctx.trace is not None:
            device_info["busy_s"] = ctx.trace.busy_s
            device_info["window_s"] = ctx.trace.window_s
            breakdown = ctx.trace.breakdown()
        for m in spec.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is None:
                log(f"{m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        log(f"traced span: {ctx.span_frames} frames, {ctx.span_s:.4f} s; reading it took "
            f"{time.perf_counter() - t_read:.2f} s")
        post = n_frames - (ctx.pre_span_frames or 0) - ctx.span_frames
        if ctx.span_frames and ctx.pre_span_frames and post > 0:
            post_s = t1 - t0 - ctx.pre_span_s - ctx.span_s
            log(f"host ms a frame: {1e3 * ctx.pre_span_s / ctx.pre_span_frames:.4f} before the "
                f"traced span, {1e3 * ctx.span_s / ctx.span_frames:.4f} in it, "
                f"{1e3 * post_s / post:.4f} after it")
    else:
        for m in spec.end_to_end:
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": unit}

    # ------------------------------------------------------------ correct
    for c in checks:
        c.after_window()
    failed = sum(1 for name, fe in fes.items()
                 for r in fe.stats_log[traffic_of[name].warmup:sent[name]]
                 if not bool(torch.isfinite(r[POSE]).all()))
    # the program's state goes before the reference runs
    ctx.engine = ctx.frontend = ctx.frontends = None
    del eng, fes, readers, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    readings, control = {}, {}
    for c in checks:
        readings.update(c.readings())
        if args.control:
            control.update(c.readings(control=True))
    log(f"reference: {time.perf_counter() - t_chk:.2f} s")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    limits = spec.cell.get("limits", {})
    results, correct = judge(readings, limits)
    out = {"correct": correct, "attempted": n_frames, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown:
        out["breakdown"] = breakdown
    if args.control:
        out["control_checks"], out["control_correct"] = judge(control, limits)
        for k, r in out["control_checks"].items():
            log(f"control {k}: {r['value']!r} (limit {r['limit']!r})")
    out["checks"] = results
    for k, r in results.items():
        log(f"check {k}: {r['value']!r} (limit {r['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
