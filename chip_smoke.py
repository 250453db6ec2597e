"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

0. device: requires CUDA, prints the card's name and power limit, builds the
   hand-written kernels from `densemonoslam_tpu_torch/csrc/` with nvcc (one
   process per source, started together);
1. kernel K1 (Gram reduction) against its plain PyTorch version at the
   tracking shapes: f64 agreement, zero-padding invariance, bit-identical
   reruns, one device kernel per call, and per shape the device times of
   the kernel, its previous design (`csrc/prev/gram.cu`), the plain version
   and cuBLAS beside the bound, and host call times;
2. the open-loop path: `Engine()` on the 640x480 synthetic orbit at the
   headline configuration (1<<20-surfel map, 4 pyramid levels, row stride 2,
   NID keyframing, open loop): 4 warm-up + 30 timed frames, with tracking,
   ATE, map size and kernel-launch checks.  Then compactions of the map;
3. where the time goes: 8 more frames under `torch.profiler`, with the
   device-busy share, device operations per frame and the top operations;
4. kernel K2 (whole-map deformation) against its plain version on a
   1<<20-row map and a 512-node graph: error, untouched bytes, passthrough,
   bit-identical reruns, times of the kernel, its previous design
   (`csrc/prev/deform.cu`) and the plain version beside the bound, and the
   share of warps on the kernel's uniform path;
5. the closed-loop path: the JAX bench's closed-loop leg (revisit lap of 40
   frames, 45 warm-up + 60 timed frames, loop checks every 8 frames) with
   loops, K2 launches, host syncs, ATE and map checks;
6. K2 against its plain version on the closed-loop map with the graph of
   its last accepted closure, times beside the bound; then the leg's first
   two loop checks again under `torch.profiler`, timed by stage;
7. relocalisation at 640x480: 16 ground-truth frames, a teleport, 30 frames;
   the pose must come back within 1 m, and an accepted relocalisation must
   have launched K1; K1's launches per frame;
8. K1 at the other shapes the three legs launched it at, and per shape its
   launches over the legs times (device time - bound).

Each leg sets every launch count to 0 just before it and reads the counts
just after; K1's counts are also kept per (P, C).  A kernel's time is the
CUDA-event time of back-to-back calls queued behind a spin kernel (the
kernels and the gaps between them); its launches per call are counted in a
CUDA graph of one call.

The last three lines are the card's name and power limit, a JSON summary of
the kernels and the JSON verdict.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import densemonoslam_tpu_torch  # noqa: F401  (sets the f32 matmul switches)
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.eval import ate_rmse
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import cuda_build, deform, gram
from densemonoslam_tpu_torch.tracking import odometry

GRAM_SHAPES = [(76800, 16), (19200, 16), (4800, 16), (4800, 8), (5000, 8)]
GRAM_TOL = dict(rtol=2e-5, atol=1e-2)  # tests/test_pallas.py's tolerance
N_WARMUP, N_TIMED = 4, 30
RES = (640, 480)
HEADLINE = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=True,
    nid_threshold=0.85, pyramid_levels=4, track_row_stride=2, open_loop=True,
)
# the JAX bench's closed-loop leg (bench.py:61-69,277-283)
CLOSED = dict(
    HEADLINE, open_loop=False, loop_check_interval=8, time_delta=30,
    deform_graph_sample_rate=2000, max_deform_nodes=256, loop_min_inactive_frac=0.05,
    loop_cons_err_thresh=0.02,
)
LAP, CL_WARMUP, CL_TIMED = 40, 45, 60
# the JAX package's closed-loop leg on a CPU (jax 0.9.0, bench._run_slam with
# CLOSED, lap 40): the yardstick printed beside the port's numbers
JAX_CLOSED = dict(ate_mm=115.06, loops_timed=4, loops_all=5, surfels=1048575, ferns=5)
# K2 against its plain version (both subtract first; the kernel contracts
# multiply-adds and sums its 4 nodes in registers): f32 rounding over ~20
# dependent operations at coordinates <= 10 m, well inside 1e-4
DEFORM_TOL = 1e-4
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SPIN_HZ = 1.98e9  # the H100 SXM's top SM clock: `torch.cuda._sleep` spins in cycles
DEFORM_FLOP_PER_ROW = 330  # 20 candidates x 8 + weights, blend and apply


def log(msg: str) -> None:
    print(msg, flush=True)


def call_ms(fn, n: int = 50) -> float:
    """Median over `n` calls of one call's latency, host clock with
    `torch.cuda.synchronize()` before and after each call."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(samples)


def _device_us(prof) -> tuple[float, int]:
    """(summed device time in us, number of device operations: kernels,
    copies, fills) of a profile."""
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return float(sum(spans)), len(spans)


def device_ms(fn, n: int = 50) -> float:
    """Mean device time of one call over `n` back-to-back calls, from CUDA
    events.  A spin kernel first holds the stream for four times as long as
    the host takes to queue the `n` calls, so the events time the device
    alone (the kernels and the gaps between them), not the host's launch
    rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4 * n * host_s * SPIN_HZ, 2**62)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _prev_gram_lib():
    def declare(lib):
        lib.gram_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.gram_f32.restype = ctypes.c_int
        lib.gram_rows_per_block.restype = ctypes.c_int
    return cuda_build.load("prev/gram", declare)


def prev_gram(M: torch.Tensor) -> torch.Tensor:
    """K1's previous design (`csrc/prev/gram.cu`: two launches, C x C
    entries per block), called as its own wrapper called it."""
    lib = _prev_gram_lib()
    P, C = M.shape
    rows = lib.gram_rows_per_block()
    partials = torch.empty(((P + rows - 1) // rows, C, C), dtype=torch.float32, device=M.device)
    out = torch.empty((C, C), dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = lib.gram_f32(M.data_ptr(), partials.data_ptr(), out.data_ptr(), P, C, stream)
    if err != 0:
        raise RuntimeError(f"previous gram kernel launch failed: cudaError {err}")
    return out


def prev_deform(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
    """K2's previous design (`csrc/prev/deform.cu`: one thread per row, the
    node table staged by every block), called as its own wrapper called it."""
    def declare(lib):
        lib.deform_map_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, *[ctypes.c_void_p] * 6, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.deform_map_f32.restype = ctypes.c_int
    lib = cuda_build.load("prev/deform", declare)
    count64 = count.to(torch.int64)
    valid = graph.valid.to(torch.uint8).contiguous()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.deform_map_f32(
            data.data_ptr(), data.shape[0] - 1, count64.data_ptr(), graph.pos.data_ptr(),
            graph.time.data_ptr(), valid.data_ptr(), graph.A.data_ptr(), graph.t.data_ptr(),
            graph.pos.shape[0], stream,
        )
    if err != 0:
        raise RuntimeError(f"previous deform kernel launch failed: cudaError {err}")
    return data


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("[phase 0] card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = cuda_build.build("gram", "deform", "prev/gram", "prev/deform")
    log(f"[phase 0] built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    return smi


def bound_ms(n_bytes: float, n_flop: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and f32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flop / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_gram(shapes=GRAM_SHAPES) -> dict:
    """K1 at each (P, C): f64 agreement, bit-identical reruns and zero-padding
    invariance; device times of the kernel, its previous design, the plain
    version and cuBLAS beside the bound; device kernels per call (must be 1)
    and host call times."""
    gen = np.random.default_rng(0)
    worst = 0.0
    times = {}
    for P, C in shapes:
        M = torch.from_numpy(gen.normal(0, 1, (P, C)).astype(np.float32)).cuda()
        out = gram.gram(M)
        again = gram.gram(M)
        padded = gram.gram(torch.cat([M, torch.zeros(3000, C, device="cuda")]))
        prev = prev_gram(M)
        torch.cuda.synchronize()
        ref = gram.gram_reference(M.double())
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **GRAM_TOL)
        np.testing.assert_allclose(prev.cpu().numpy(), ref.cpu().numpy(), **GRAM_TOL)
        err = float((out.double() - ref).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, again):
            raise AssertionError(f"gram {P}x{C}: two runs differ")
        if not torch.equal(out, padded):
            raise AssertionError(f"gram {P}x{C}: zero padding changed the result")
        kernel, plain = (lambda: gram.gram(M)), (lambda: gram.gram_reference(M))
        previous = lambda: prev_gram(M)  # noqa: E731
        library = lambda: torch.matmul(M.T, M)  # noqa: E731  (cuBLAS, the yardstick)
        k_call, v_call, p_call = call_ms(kernel), call_ms(previous), call_ms(plain)
        per_call, ops = cuda_build.kernels_per_call(kernel)
        if per_call != 1 or ops != 1:
            raise AssertionError(f"gram {P}x{C}: one call enqueued {per_call} kernels in "
                                 f"{ops} device operations, not one kernel")
        k_dev, v_dev = device_ms(kernel), device_ms(previous)
        p_dev, l_dev = device_ms(plain), device_ms(library)
        b_ms, b_by = bound_ms(4.0 * (P * C + C * C), 2.0 * P * C * C)
        times[(P, C)] = dict(ms=k_dev, prev_ms=v_dev, plain_ms=p_dev, library_ms=l_dev,
                             bound_ms=b_ms, bound_by=b_by, call_ms=k_call, prev_call_ms=v_call,
                             launches_per_call=per_call)
        log(f"[phase 1] gram {P:6d}x{C:<2d} max|err| {err:.3e}  device: kernel "
            f"{k_dev * 1e3:7.2f} us ({per_call:g} kernel/call), previous {v_dev * 1e3:7.2f} us, "
            f"plain {p_dev * 1e3:7.2f} us, library {l_dev * 1e3:7.2f} us, "
            f"bound {b_ms * 1e3:6.2f} us ({b_by});  call: kernel {k_call * 1e3:7.2f} us, "
            f"previous {v_call * 1e3:7.2f} us, plain {p_call * 1e3:7.2f} us")
    return dict(max_abs_err=worst, times=times)


def reset_counts() -> None:
    """Set every kernel's launch counts to 0 (just before a path is driven)."""
    gram.LAUNCHES = 0
    gram.LAUNCHES_BY_SHAPE.clear()
    deform.LAUNCHES = 0


def by_shape() -> dict:
    """K1 launches per (P, C) since the last `reset_counts`, largest first."""
    return dict(sorted(gram.LAUNCHES_BY_SHAPE.items(), reverse=True))


def _count_syncs(fn):
    """Run `fn` with CUDA sync debugging on; return (result, #syncs)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _camera() -> CameraConfig:
    W, H = RES
    return CameraConfig(
        FrameResolution(W, H),
        CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "smoke",
    )


def phase_slam() -> dict:
    camera = _camera()
    n = N_WARMUP + N_TIMED
    seq = SyntheticSequence(camera=camera, num_frames=n, radius=0.12, max_angle=0.12)
    frames = [
        tuple(torch.from_numpy(x).cuda() for x in seq.frame(i)) for i in range(n)
    ]
    cfg = EngineConfig(**HEADLINE)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()  # count only the main path's launches from here
    for i in range(N_WARMUP):
        eng.process_frame("cam0", *frames[i], float(i), sync=False)
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        for i in range(N_WARMUP, n):
            eng.process_frame("cam0", *frames[i], float(i), sync=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dt, syncs = _count_syncs(timed)
    launches, shapes = gram.LAUNCHES, by_shape()
    peak = torch.cuda.max_memory_allocated()

    stats = torch.stack(fe.stats_log).cpu().numpy()
    est = [p for _, p in fe.trajectory]
    ate = ate_rmse(est, [seq.gt_pose(i) for i in range(len(est))])
    surfels = eng.surfel_count("cam0")
    fused = int(stats[:, 5].sum())
    gn_per_frame = sum(cfg.iterations_for_levels()) + odometry.SO3_ITERATIONS
    log(f"[phase 2] {N_TIMED} timed frames in {dt:.3f} s: {N_TIMED / dt:.2f} fps, "
        f"{1e3 * dt / N_TIMED:.2f} ms/frame")
    log(f"[phase 2] ATE {ate * 1e3:.4f} mm, surfels {surfels}, fused {fused}/{n} frames, "
        f"gram launches/frame {launches / n:.2f}, host syncs/frame {syncs / N_TIMED:.2f}, "
        f"peak device memory {peak / 2**20:.1f} MiB")
    log(f"[phase 2] gram launches by (P, C) over the {n} frames: {shapes}")
    if not (stats[:, 0] == 1.0).all():
        raise AssertionError(f"tracking lost at frames {np.nonzero(stats[:, 0] != 1.0)[0]}")
    if not np.isfinite(stats).all():
        raise AssertionError("non-finite stats")
    if not ate < 0.010:
        raise AssertionError(f"ATE {ate * 1e3:.3f} mm >= 10 mm")
    if not surfels > 10000:
        raise AssertionError(f"only {surfels} surfels")
    if launches < n * gn_per_frame:
        raise AssertionError(
            f"{launches} gram launches < {n} frames x {gn_per_frame} SO3+GN iterations"
        )

    # the periodic compaction (every 64 frames in the engine) at this map size
    m = eng.map_of("cam0")
    alive = int(m.alive.sum())
    samples = []
    for _ in range(6):  # `compact` leaves `m` untouched, so each call redoes the same work
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc = sm.compact(m, time=float(eng.global_tick), time_delta=cfg.time_delta,
                        max_active=eng._max_active())
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0))
    if int(mc.count) != alive or not bool(mc.alive[: alive].all()):
        raise AssertionError("compaction lost or misplaced live surfels")
    log(f"[phase 2] compact of the {cfg.max_surfels}-row map: first call "
        f"{samples[0]:.2f} ms, then median {statistics.median(samples[1:]):.2f} ms "
        f"(min {min(samples[1:]):.2f}, max {max(samples[1:]):.2f}) over 5")
    return dict(launches=launches, shapes=shapes, engine=eng, frames=frames)


def phase_profile(eng, frames) -> None:
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    frames_n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames_n):
            eng.process_frame("cam0", *frames[i % n], float(n + i), sync=False)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / frames_n
    busy, ops = _device_us(prof)
    log(f"[phase 3] {frames_n} frames under the profiler: {wall:.2f} ms/frame wall, device "
        f"busy {busy / 1e3 / frames_n:.2f} ms/frame, {ops / frames_n:.0f} device ops/frame")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                  max_name_column_width=48))


def _deform_checks(label: str, data: torch.Tensor, count: torch.Tensor, graph) -> dict:
    """K2 against `deform_map_reference` on the same map and graph: error on
    positions and normals, every other byte untouched, bit-identical reruns;
    device times of both and the bound from this map's live rows."""
    out_k = deform.deform_map(data.clone(), count, graph)
    again = deform.deform_map(data.clone(), count, graph)
    out_p = deform.deform_map_reference(data.clone(), count, graph)
    torch.cuda.synchronize()
    if not torch.equal(out_k, again):
        raise AssertionError(f"deform {label}: two runs differ")
    cols = [sm.CONF, *range(4, 8), sm.INIT_TIME, *range(12, 16)]
    if not torch.equal(out_k[:, cols], data[:, cols]):
        raise AssertionError(f"deform {label}: a column other than position/normal changed")
    n = int(count)
    alive = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    alive[:n] = data[:n, sm.CONF] > 0
    if not torch.equal(out_k[~alive], data[~alive]):
        raise AssertionError(f"deform {label}: a dead row or a row >= count changed")
    err_p = float((out_k[:, sm.POS] - out_p[:, sm.POS]).abs().max())
    err_n = float((out_k[:, sm.NORMAL] - out_p[:, sm.NORMAL]).abs().max())
    moved = float((out_k[:, sm.POS] - data[:, sm.POS]).abs().max())
    if not (err_p <= DEFORM_TOL and err_n <= DEFORM_TOL):
        raise AssertionError(f"deform {label}: max|err| pos {err_p:.3e} normal {err_n:.3e}")
    out_v = prev_deform(data.clone(), count, graph)
    torch.cuda.synchronize()
    err_v = float((out_v - out_p).abs().max())
    if not err_v <= DEFORM_TOL:
        raise AssertionError(f"deform {label}: previous design's max|err| {err_v:.3e}")
    scratch = data.clone()
    kernel = lambda: deform.deform_map(scratch, count, graph)  # noqa: E731
    per_call, ops = cuda_build.kernels_per_call(kernel)
    if per_call != 2 or ops != 2:  # the node-table prologue and the map kernel
        raise AssertionError(f"deform {label}: one call enqueued {per_call} kernels in "
                             f"{ops} device operations, not two kernels")
    k_dev = device_ms(kernel, n=20)
    v_dev = device_ms(lambda: prev_deform(scratch, count, graph), n=20)
    p_dev = device_ms(lambda: deform.deform_map_reference(scratch, count, graph), n=3)
    n_alive = int(alive.sum())
    K = graph.pos.shape[0]
    b_ms, b_by = bound_ms(32.0 * n + 24.0 * n_alive + 68.0 * K, DEFORM_FLOP_PER_ROW * n_alive)
    share = uniform_warp_share(data, count, graph)
    log(f"[deform] {label}: {n_alive} live rows of {data.shape[0] - 1}, K={K}, "
        f"max|err| pos {err_p:.3e} normal {err_n:.3e} (largest move {moved:.3e} m); "
        f"device: kernel {k_dev * 1e3:.2f} us ({per_call:g} kernels/call), previous "
        f"{v_dev * 1e3:.2f} us, plain {p_dev * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
        f"warps on the uniform path {100 * share:.2f}%")
    return dict(max_abs_err=max(err_p, err_n), ms=k_dev, prev_ms=v_dev, plain_ms=p_dev,
                bound_ms=b_ms, bound_by=b_by)


def uniform_warp_share(data: torch.Tensor, count: torch.Tensor, graph) -> float:
    """Share of K2's warps (32 consecutive rows from row 0, with a live row)
    whose live rows all share one window start: the warps that take the
    kernel's uniform path, computed from the map's creation times."""
    n = min(int(count), data.shape[0] - 1)
    rows = data[:n]
    live = rows[:, sm.CONF] > 0
    ins = torch.searchsorted(graph.time, rows[:, sm.INIT_TIME].contiguous(), right=True)
    top = max(int(graph.valid.sum()) - deform.LOOKBACK, 0)
    start = torch.clamp(ins - deform.LOOKBACK, min=0, max=top)
    pad = (-n) % 32
    live = torch.nn.functional.pad(live, (0, pad)).view(-1, 32)
    start = torch.nn.functional.pad(start, (0, pad)).view(-1, 32)
    big = torch.iinfo(start.dtype).max
    lo = torch.where(live, start, big).amin(dim=1)
    hi = torch.where(live, start, -1).amax(dim=1)
    warps = live.any(dim=1)
    return float(((lo == hi) & warps).sum()) / max(int(warps.sum()), 1)


def phase_deform_synthetic() -> dict:
    """K2 on a random 1<<20-row map with a 512-node graph (a few invalid
    nodes inside, the last 32 invalid), times with ties, 10% dead rows and
    live rows past `count`; then the all-invalid graph must pass every row
    through bit for bit."""
    gen = np.random.default_rng(1)
    N, K = 1 << 20, deform.MAX_NODES
    data = np.zeros((N + 1, sm.COLS), np.float32)
    data[:N, sm.POS] = gen.uniform(-3, 3, (N, 3))
    data[:N, sm.CONF] = gen.uniform(0.5, 20, N) * (gen.random(N) > 0.1)
    data[:N, 4:8] = gen.uniform(0, 255, (N, 4))
    nrm = gen.normal(size=(N, 3))
    data[:N, sm.NORMAL] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    data[:N, sm.INIT_TIME] = np.floor(gen.uniform(-5, 205, N))
    data[:N, 12:16] = gen.uniform(0, 200, (N, 4))
    nv = K - 32
    pos = np.zeros((K, 3), np.float32)
    pos[:nv] = gen.uniform(-3, 3, (nv, 3))
    time_ = np.full(K, np.inf, np.float32)
    time_[:nv] = np.sort(np.floor(gen.uniform(0, 200, nv)))
    valid = np.zeros(K, bool)
    valid[:nv] = gen.random(nv) > 0.05
    A = (np.eye(3)[None] + 0.05 * gen.normal(size=(K, 3, 3))).astype(np.float32)
    t = (0.05 * gen.normal(size=(K, 3))).astype(np.float32)
    graph = dg.graph_from_numpy(dict(pos=pos, time=time_, valid=valid, A=A, t=t), "cuda")
    d = torch.from_numpy(data).cuda()
    count = torch.full((), N - 4096, dtype=torch.int64, device="cuda")
    res = _deform_checks("synthetic 1<<20 rows, 512 nodes", d, count, graph)
    out = deform.deform_map(d.clone(), count, dg.empty_graph(K))
    torch.cuda.synchronize()
    if not torch.equal(out, d):
        raise AssertionError("deform: rows without support did not pass through unchanged")
    log("[deform] all-invalid graph: every row passed through bit for bit")
    return res


def phase_closed_loop() -> dict:
    """The closed-loop leg at full width; per-frame wall time and host syncs
    separate the loop-check frames from the others."""
    camera = _camera()
    seq = SyntheticSequence(camera=camera, num_frames=LAP, radius=0.35, max_angle=0.3)
    frames = [tuple(torch.from_numpy(x).cuda() for x in seq.frame(i)) for i in range(LAP)]
    cfg = EngineConfig(**CLOSED)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    closed = []  # per frame: did it close a loop
    for i in range(CL_WARMUP):
        c0 = fe.loops_closed
        eng.process_frame("cam0", *frames[i % LAP], float(i), sync=False)
        closed.append(fe.loops_closed > c0)
    torch.cuda.synchronize()
    loops_pre = fe.loops_closed
    reset_counts()  # count only this path's launches from here
    walls, syncs, checks = [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t_start = time.perf_counter()
            for i in range(CL_WARMUP, CL_WARMUP + CL_TIMED):
                n0, c0 = len(caught), fe.loops_closed
                t0 = time.perf_counter()
                eng.process_frame("cam0", *frames[i % LAP], float(i), sync=False)
                walls.append(time.perf_counter() - t0)
                syncs.append(sum("synchroniz" in str(w.message) for w in caught[n0:]))
                checks.append(fe.tick % cfg.loop_check_interval == 0 and fe.tick > 2)
                closed.append(fe.loops_closed > c0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t_start
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(gram=gram.LAUNCHES, deform=deform.LAUNCHES)
    shapes = by_shape()
    walls, syncs = 1e3 * np.array(walls), np.array(syncs, float)
    closed_all = np.array(closed)
    checks, closed = np.array(checks), closed_all[CL_WARMUP:]
    loops_timed = fe.loops_closed - loops_pre
    stats = torch.stack(fe.stats_log).cpu().numpy()
    est = [p for _, p in fe.trajectory]
    ate = ate_rmse(est, [seq.gt_pose(i % LAP) for i in range(len(est))])
    surfels = eng.surfel_count("cam0")
    dropped = int(stats[:, stepmod.STAT_DROPPED].sum())
    ferns = int(fe.fern_state.db.count)
    base = float(np.median(walls[~checks]))
    per_check = float(walls[checks].mean() - base) if checks.any() else float("nan")
    per_closure = float(walls[closed].mean() - base) if closed.any() else float("nan")
    sync_plain = float(syncs[~checks].mean())
    sync_check = float(syncs[checks].mean() - sync_plain) if checks.any() else float("nan")
    log(f"[closed] {CL_TIMED} timed frames in {dt:.3f} s: {CL_TIMED / dt:.2f} fps, "
        f"{1e3 * dt / CL_TIMED:.2f} ms/frame; plain frames median {base:.2f} ms")
    log(f"[closed] loops closed: {loops_timed} in the timed frames, {fe.loops_closed} in all; "
        f"{int(checks.sum())} loop checks, {per_check:.2f} ms per loop check, "
        f"{per_closure:.2f} ms per accepted closure (frame wall minus the plain-frame median)")
    log(f"[closed] host syncs: {sync_plain:.2f}/frame without a loop check, "
        f"{sync_check:.2f} more per loop check ({syncs.sum():.0f} in all); "
        f"launches: gram {launches['gram']}, deform {launches['deform']}")
    log(f"[closed] gram launches by (P, C) over the {CL_TIMED} timed frames: {shapes}")
    log(f"[closed] ATE {ate * 1e3:.2f} mm against gt_pose(i % {LAP}); surfels {surfels}, "
        f"dropped {dropped}, fern keyframes {ferns}")
    log(f"[closed] JAX package on a CPU, same leg: ATE {JAX_CLOSED['ate_mm']} mm, "
        f"{JAX_CLOSED['loops_timed']} loops in the timed frames ({JAX_CLOSED['loops_all']} in all), "
        f"surfels {JAX_CLOSED['surfels']}, fern keyframes {JAX_CLOSED['ferns']}")
    # an accepted closure invalidates the stored model, so the next frame
    # keeps the corrected pose untracked and re-renders; any other frame
    # whose tracking failed means the camera was lost
    failed = set(np.nonzero(stats[:, stepmod.STAT_TRACK_OK] != 1.0)[0].tolist())
    after_closure = {i + 1 for i in np.nonzero(closed_all)[0].tolist()}
    log(f"[closed] frames not tracked: {sorted(failed)}; frames right after a closure: "
        f"{sorted(after_closure)}")
    if not failed <= after_closure:
        raise AssertionError(f"tracking lost at frames {sorted(failed - after_closure)}")
    if not np.isfinite(stats).all():
        raise AssertionError("non-finite stats")
    if loops_timed < 1:
        raise AssertionError(f"no loop closed in the timed frames: {fe.last_loop_info}")
    if launches["deform"] < loops_timed:
        raise AssertionError(f"{launches['deform']} deform launches < {loops_timed} closures")
    if launches["gram"] == 0:
        raise AssertionError("the closed-loop path launched no gram kernel")
    if not ate < 0.250:
        raise AssertionError(f"ATE {ate * 1e3:.2f} mm >= 250 mm")
    m = eng.map_of("cam0")
    return dict(launches=launches, shapes=shapes, graph=fe.last_loop_graph, data=m.data,
                count=m.count, frames=frames, ate_mm=1e3 * ate, loops_timed=loops_timed,
                loops_all=fe.loops_closed, surfels=surfels)


def phase_closure_profile(frames) -> None:
    """The closed-loop leg again from its start, with frames 36-51 (the loop
    checks at ticks 40 and 48, where the leg's first closures land) under
    `torch.profiler`: the host wall time of each `loop.*` stage, and the
    device time of the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile

    seq = SyntheticSequence(camera=_camera(), num_frames=LAP, radius=0.35, max_angle=0.3)
    eng = Engine(_camera(), EngineConfig(**CLOSED))
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(36):
        eng.process_frame("cam0", *frames[i % LAP], float(i), sync=False)
    closed0 = fe.loops_closed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(36, 52):
            eng.process_frame("cam0", *frames[i % LAP], float(i), sync=False)
        torch.cuda.synchronize()
    log(f"[closure profile] frames 36-51, 2 loop checks, {fe.loops_closed - closed0} closed:")
    for e in sorted(prof.key_averages(), key=lambda e: e.key):
        # the host-side range (its GPU-timeline twin carries no host time)
        if e.key.startswith("loop.") and e.device_type == torch.autograd.DeviceType.CPU:
            dev = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            log(f"[closure profile] {e.key:20s} {e.count:2d} calls, host wall "
                f"{e.cpu_time_total / 1e3 / e.count:9.2f} ms/call, device "
                f"{dev / 1e3 / e.count:8.2f} ms/call")


def phase_relocalisation() -> dict:
    """`tests/test_engine.py`'s relocalisation scenario at 640x480; returns
    the Gram launches of the frames after the teleport, in all and by shape."""
    camera = _camera()
    seq = SyntheticSequence(camera=camera, num_frames=40, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(
        max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, open_loop=False,
        nid_keyframing=False, relocalisation=True, loop_check_interval=4, time_delta=200,
        pyramid_levels=4, track_row_stride=2,
    )
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(16):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    ferns = int(fe.fern_state.db.count)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [5.0, 5.0, 5.0]
    fe.pose = bad
    fe.state = fe.state.replace(model_age=torch.full_like(fe.state.model_age, 1 << 20))
    calls = []
    in_reloc = []  # gram launches inside each relocalisation attempt
    relocalise = eng.relocalise

    def counting(*a, **k):
        before = gram.LAUNCHES
        calls.append(relocalise(*a, **k))
        in_reloc.append(gram.LAUNCHES - before)
        return calls[-1]

    # tracking levels re-run after a starved level (`fallback="select"`
    # runs both the exact and the frozen iterations of each later level)
    gn_level = odometry._gn_level
    reruns = [0]

    def counting_level(*a, **k):
        reruns[0] += k.get("fallback") == "select"
        return gn_level(*a, **k)

    eng.relocalise = counting
    odometry._gn_level = counting_level
    per_frame = []  # (gram launches, of them inside relocalisation, levels re-run)
    reset_counts()  # count only this path's launches from here
    try:
        for i in range(30):
            n0, r0, s0 = gram.LAUNCHES, sum(in_reloc), reruns[0]
            eng.process_frame("cam0", *seq.frame(i % 16), float(100 + i))
            per_frame.append((gram.LAUNCHES - n0, sum(in_reloc) - r0, reruns[0] - s0))
    finally:
        odometry._gn_level = gn_level
    launches, shapes = gram.LAUNCHES, by_shape()
    err = float(np.linalg.norm(fe.pose[:3, 3] - seq.gt_pose(15)[:3, 3]))
    log(f"[reloc] {ferns} fern keyframes; {len(calls)} relocalisation attempts, "
        f"{sum(calls)} accepted; final pose {err:.3f} m from the map's last ground-truth pose")
    log(f"[reloc] gram launches: {launches} in the 30 frames after the teleport, "
        f"{sum(in_reloc)} of them inside relocalisation attempts")
    log(f"[reloc] per frame (gram launches, of them in relocalisation, levels re-run "
        f"after starving): {per_frame}")
    log(f"[reloc] gram launches by (P, C): {shapes}")
    if ferns < 1:
        raise AssertionError("no fern keyframe stored")
    if not any(calls):
        raise AssertionError(f"no relocalisation accepted ({len(calls)} attempts)")
    if sum(launches for ok, launches in zip(calls, in_reloc) if ok) == 0:
        raise AssertionError("an accepted relocalisation launched no gram kernel")
    if not err < 1.0:
        raise AssertionError(f"pose still {err:.2f} m from the map")
    return dict(launches=launches, shapes=shapes)


def main() -> int:
    smi = phase_device()
    k1 = phase_gram()
    slam = phase_slam()
    phase_profile(slam["engine"], slam["frames"])
    del slam["engine"], slam["frames"]
    torch.cuda.empty_cache()
    k2_synth = phase_deform_synthetic()
    closed = phase_closed_loop()
    k2_real = _deform_checks(
        "closed-loop map, last closure's graph", closed["data"], closed["count"], closed["graph"]
    )
    del closed["data"], closed["graph"]
    phase_closure_profile(closed.pop("frames"))
    torch.cuda.empty_cache()
    reloc = phase_relocalisation()
    # K1 at the shapes the legs launched it at that phase 1 did not cover,
    # then launches x (time - bound) per shape over the three legs
    legs = [slam["shapes"], closed["shapes"], reloc["shapes"]]
    seen = sorted({shape for leg in legs for shape in leg}, reverse=True)
    more = phase_gram([shape for shape in seen if shape not in k1["times"]])
    k1["times"].update(more["times"])
    k1["max_abs_err"] = max(k1["max_abs_err"], more["max_abs_err"])
    for shape in seen:
        n = sum(leg.get(shape, 0) for leg in legs)
        t = k1["times"][shape]
        log(f"[gram] {shape[0]}x{shape[1]}: {n} launches (open {slam['shapes'].get(shape, 0)}, "
            f"closed {closed['shapes'].get(shape, 0)}, reloc {reloc['shapes'].get(shape, 0)}), "
            f"launches x (time - bound) {n * (t['ms'] - t['bound_ms']):.3f} ms, "
            f"previous design {n * (t['prev_ms'] - t['bound_ms']):.3f} ms")
    g = k1["times"][GRAM_SHAPES[0]]
    log(smi)
    print(json.dumps({"kernels": [
        {
            "name": "gram",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/gram.cu",
            "replaces": "densemonoslam_tpu/ops/pallas/gram.py:66",
            "launches": slam["launches"] + closed["launches"]["gram"] + reloc["launches"],
            "launches_per_call": g["launches_per_call"],
            "max_abs_err": k1["max_abs_err"],
            "ms": g["ms"],
            "prev_ms": g["prev_ms"],
            "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"],
            "library_ms": g["library_ms"],
        },
        {
            "name": "deform",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/deform.cu",
            "replaces": "densemonoslam_tpu/ops/pallas/deform.py:201",
            "launches": closed["launches"]["deform"],
            "max_abs_err": max(k2_synth["max_abs_err"], k2_real["max_abs_err"]),
            "ms": k2_real["ms"],
            "prev_ms": k2_real["prev_ms"],
            "plain_ms": k2_real["plain_ms"],
            "bound_ms": k2_real["bound_ms"],
            "bound_by": k2_real["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
