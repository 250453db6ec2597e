"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --k3     # phases 0 and 4b

Phases (any failure raises, so the exit code is not 0):

0. device: requires CUDA, prints the card's name and power limit, builds the
   hand-written kernels from `densemonoslam_tpu_torch/csrc/` with nvcc (one
   process per source, started together), K1, K2, K3, the IF-node condition
   setter of the captured programs (`graph_if.cu`) and the step's stage
   stamp (`stamp.cu`);
1. kernel K1 (Gram reduction) against its plain PyTorch version at the
   tracking shapes: f64 agreement, zero-padding invariance, bit-identical
   reruns, one device kernel per call, and per shape the device times of
   the kernel, its previous design (`csrc/prev/gram.cu`), the plain version
   and cuBLAS beside the bound, and host call times;
1b. K1's fused form, the whole tracking iteration (`csrc/track_iter.cu`),
   at the main paths' shapes (revisit 76800, 19200 and 4800 rows, mono
   81920; SO3 4800 x 8): an exact and a frozen iteration each against the
   former chain (the same iteration op by op on the card, K1 inside) from
   the same carry and sample (pose, stats and `done`), device times of the
   same two iterations fused and of the chain captured as a CUDA graph,
   beside K1's bound for the rows and the fused kernel's own; then a whole
   track at the cells' settings against the plain track on the CPU: its
   pose (1e-4 m / 1e-4 rad), its fused launches by mode (39) and its device
   operations (at most 60) against the plain composition's.  Every leg
   after it checks that each of its K1 launches was a fused iteration;
2. the open-loop path: `Engine()` on the 640x480 synthetic orbit at the
   headline configuration (1<<20-surfel map, 4 pyramid levels, row stride 2,
   NID keyframing, open loop): 4 warm-up + 30 timed frames, with tracking,
   ATE, map size and kernel-launch checks.  Then compactions of the map.
   On the card every engine runs the step as one CUDA graph with on-device
   branches (`step.make_graphed_step`), and every closure its GN-CG as one
   (`deformation.optimise_graphed`); launches inside a graph's branches are
   settled from the device before each count is read;
3. where the time goes: 4 more frames under `torch.profiler`, with the
   device-busy share, device operations per frame and the top operations;
3a. the captured step: the open-loop leg eager (the eager reference run)
   and graphed in alternating pairs: wall and CUDA-event ms a frame, a
   replay's device ms, host syncs by source line (none in the step's
   replays), captures, replays and state copies (none in the timed
   frames), capture seconds, poses against the eager run's (1e-4 m), both
   ATEs < 10 mm, K1 launches through replays equal to the eager run's; then
   an IF node against the plain `if` and its device time, and the stage
   stamp against the CPU's ring (tick tags equal, each frame's times in
   stamp order, ticks past the ring's length) and its device time;
3b. the odometry leg: `examples/torch_run_synthetic.py` at 640x480 on its
   orbit, 30 frames: frame-to-frame tracking (5 levels; fps, ATE < 20 mm, no
   failure, K1 launches by shape, device-busy ms per tracked frame under
   `torch.profiler`), then the example's own 3 levels and its full engine
   (reported), the batched pose history against a flush after every frame
   on a short closed-loop run (bit-identical trajectories, ticks and
   checkpoints; history writes per frame), and one level of the unpacked
   ICP and RGB rows (307200x8 each) through K1 against its plain version;
4. kernel K2 (whole-map deformation) against its plain version on a
   1<<20-row map and a 512-node graph: error, untouched bytes, passthrough,
   bit-identical reruns, times of the kernel, its previous design
   (`csrc/prev/deform.cu`) and the plain version beside the bound, and the
   share of warps on the kernel's uniform path;
4b. kernel K3 (the render of the whole map, `csrc/zbuffer.cu`) against its
   plain version (`splat.render_ops`, the exact two-scatter path) on a
   1<<25-row map with 15 M rows in use, in the INACTIVE, ALL and ACTIVE
   modes: the same winner on every pixel, no row at or above the count
   drawn, the float maps within 1e-6 relative, a memset and two kernels a
   call; device times of the kernel, of the whole `splat.render` call and
   of the plain version beside the bound (`python3 chip_smoke.py --k3` runs
   phase 0 and this phase alone);
5. the closed-loop path: the JAX bench's closed-loop leg (revisit lap of 40
   frames, 45 warm-up + 60 timed frames, loop checks every 8 frames) with
   loops, K2 launches, host syncs, ATE and map checks; then, after the
   timed frames, one loop check that closes (of at most three) under
   `torch.profiler`, timed by stage; then each GN-CG call of the leg again
   on its inputs, graphed against eager: node transforms within 1e-5, the
   energies, wall, CUDA-event and device ms;
6. K2 against its plain version on the closed-loop map with the graph of
   its last accepted closure, times beside the bound;
7. relocalisation at 640x480: 16 ground-truth frames, a teleport, 30 frames;
   the pose must come back within 1 m, and an accepted relocalisation must
   have launched K1; K1's launches per frame;
8. the monocular street leg, the JAX bench's `_run_mono_street`
   configuration on the port: `StreetSequence` at KITTI 1024x320 (520
   frames, rendered on the host by a pool that runs during legs 1-7, then
   renders leg 14's), the
   packaged street depth net, ORB tracking with local BA, hybrid loops, a
   1<<22-surfel map; the frames stay in host memory and each is uploaded
   by `process_frame`, as in the bench; the lap's first 320 frames: 66
   warm-up frames, 4 under `torch.profiler` (device-busy ms and the depth
   CNN / sparse tracker / dense step ranges), then frames 70-319 timed with
   host syncs counted: fps, ATE, loops, surfels, launches; then K2 against
   its plain version on the leg's full map with a graph sampled from it;
9. the standalone street sparse lap (`tests/test_street.py`'s full-lap
   loop closure) on the same frames and their true depth: >= 1 loop and a
   final error < 0.5 m;
10. the hybrid closure of `tests/test_hybrid.py` (a two-epoch drifted map,
   a known correction) at 640x480: accepted within that test's bounds,
   through K2; then K2 against its plain version on the map before the
   closure with the graph the closure applied;
11. two cameras in one engine (`tests/test_intermap.py` at 640x480): camB
   in its own frame, poses injected until the maps merge (the loop-check
   frames profiled for the merge's `merge.*` ranges) within that test's
   bounds; then both track densely into the one map (ms and host syncs per
   camera-frame, ATE, a profiled breakdown); then `tests/test_engine.py`'s
   batch align;
12. a collaborative session of gloo ranks on the one card, each a process
   (`chip_smoke.py --collab-rank`) joined by `multihost.initialize()`:
   collab steps timed on 1 rank, then on 2 ranks the inter-map rounds to a
   merge both ranks report identically (and the merge round again with
   consume), the full pipeline with every camera closing a loop,
   distributed PGO/BA against one device and the sharded K2 apply against
   one rank's K2, bit for bit; the ranks' launches are summed;
13. the application layer, as a user starts it, at 640x480: the host's
   codecs probed (PIL, the native codec library built from
   `native/framecodec.cpp`), then `cli.main` in this process on two `.klg`
   logs of the synthetic orbit (one camera, then two, each checked for its
   exports and ATE against the orbit's truth), the single-camera `main()`
   path with its four exports, checkpoint/resume on the card against the
   run-to-run difference (and a checkpoint the CPU wrote, loaded on the
   card), a 30 Hz live UDP stream into `cli.main --live-port` (frames sent,
   received, processed), and a `ViewerServer` on the two-camera engine;
14. the depth CNN's training (`examples/torch_train_depthnet{,_street}.py`,
   their frames rendered by the background pool after the mono leg's): the
   gradient and 5 steps' losses on the card against the CPU from one
   flax-style start, the synthetic trainer (600 steps, its own <10%
   held-out assertion, the loss halved) and the street trainer (800 steps,
   both held-out errors < 20%, the loss halved) at their own
   configurations, then the card-trained synthetic net loaded through
   `DepthPredictor.load` in the monocular engine (`tests/test_depthnet.py`'s
   10 RGB-only frames, through K1); ms per train step at the trainers'
   three shapes, steps/s, peak device memory;
15. the measurement entry points: `torch_bench.py`'s legs that no phase
   above runs, at 30 timed frames each (the open loop beside
   relocalisation, the 1024x320 orbit, the default configuration, the
   1<<25-row map; fps, ATE, peak device memory), then
   `examples/torch_profile_stages.py` at 640x480 (wall and device ms per
   stage), then K2 against its plain version on
   `examples/torch_profile_closure.py`'s map (1<<22 rows, 2,097,152 live)
   with the graph its closure applies;
16. the legs' fused launches per K1 shape and in all, and gram(M)'s own
   launches (its checks above; none on the main paths).

Each leg sets every launch count to 0 just before it and reads the counts
just after; K1's counts are also kept per (P, C).  The IF-node condition
setter's launches are those of phase 3a's two graphed runs; the stage
stamp's are those of every leg that runs the engine's step.  A kernel's time is the
CUDA-event time of back-to-back calls queued behind a spin kernel (the
kernels and the gaps between them); its launches per call are counted in a
CUDA graph of one call.

The last three lines are the card's name and power limit, a JSON summary of
the kernels and the JSON verdict.  `[time]` lines give each phase's wall
time.
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import multiprocessing
import os
import socket
import statistics
import struct
import subprocess
import sys
import time
import warnings
from multiprocessing import shared_memory

import numpy as np
import torch

import densemonoslam_tpu_torch  # noqa: F401  (sets the f32 matmul switches)
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.eval import ate_rmse
from densemonoslam_tpu_torch.io.street import StreetSequence
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.models.depthnet import DepthPredictor
from densemonoslam_tpu_torch.ops import (
    cuda_build, deform, gram, preprocess, reductions, splat, zbuffer,
)
from densemonoslam_tpu_torch.tracking import odometry
from densemonoslam_tpu_torch.tracking.sparse import SparseTracker
from densemonoslam_tpu_torch.utils import graphs, timer
from densemonoslam_tpu_torch.utils import se3 as se3mod
from densemonoslam_tpu_torch.utils import launches as klaunches

# the first is the kernels line's headline shape (the open loop's finest level)
GRAM_SHAPES = [(76800, 16), (19200, 16), (4800, 16), (4800, 8), (5000, 8), (307200, 8)]
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
# the JAX bench's monocular street leg (bench.py:119-209)
# 4 frames profiled (8 until the app leg came): reading a profile of ~14,000
# device operations a frame takes the host ~10 s a frame, and the smoke must
# stay inside its time limit
STREET_FRAMES, STREET_WARMUP, STREET_PROFILED = 520, 70, 4
# the mono leg drives the lap's first 320 frames (250 timed): the whole
# smoke must finish well inside its time limit on the slowest hosts seen,
# and the multi-camera legs took the time of 200 more mono frames
MONO_FRAMES = 320
MONO = dict(
    max_surfels=1 << 22, depth_cutoff=40.0, max_depth=80.0, depth_factor=1.0,
    depth_gate_rel=0.1, nid_keyframing=True, open_loop=True, predict_depth=True,
    orb_tracking=True, hybrid_loops=True, time_delta=200, pyramid_levels=4, track_row_stride=2,
)
MONO_TRACKER = dict(run_local_ba=True, keyframe_min_disp=1.0, loop_min_gap=100)
# tests/test_hybrid.py::test_apply_hybrid_loop_folds_map's configuration, with
# the map scaled by the 16x pixel count of 640x480 over 160x120 so that it
# holds the same scene
HYBRID = dict(
    max_surfels=1 << 22, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=50, deform_graph_sample_rate=600, max_deform_nodes=128,
    loop_cons_err_thresh=0.02, confidence_threshold=1.0,
)
HYBRID_DRIFT = np.array([0.08, 0.0, 0.0], np.float32)
# K2 against its plain version (both subtract first; the kernel contracts
# multiply-adds and sums its 4 nodes in registers): f32 rounding over ~20
# dependent operations at coordinates <= 10 m, well inside 1e-4; positions
# farther out get it in proportion (`_deform_checks`)
DEFORM_TOL = 1e-4
# the odometry leg: `examples/torch_run_synthetic.py` at 640x480 on the JAX
# example's orbit (radius 0.35, max angle 0.3), 30 frames, with its exit
# code's ATE bound.  5 levels, so that the coarsest level (SO3's) is 40x30 as
# the example's 3 levels make it at 160x120.  With fewer levels the JAX
# package fails this orbit as the port does (`tools/odometry_levels_witness.py`
# on a CPU): at 3 levels both lose frame 2 by 77 mm and frames 12-17 by up to
# 190 mm, at 4 both lose frames 14-16 by up to 28 mm (ATE 25.8 mm in each).
# The 3-level run is reported too
ODO_FRAMES, ODO_LEVELS, ODO_PROFILED, ODO_ATE_M = 30, 5, 6, 0.02
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
    copies, fills) of a profile.  The device-side twins of `record_function`
    ranges (user annotations spanning a whole range, gaps included) are not
    operations and are left out."""
    spans = [e.time_range.elapsed_us() for e in _device_ops(prof)]
    return float(sum(spans)), len(spans)


def _device_ops(prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("frame", "loop.", "sparse.", "host.read"))]


def _top_device_ops(prof, n: int = 10) -> list:
    """The `n` device operations of a profile with the most device time:
    [(name, (count, summed us))], on the same events as `_device_us`."""
    acc: dict = {}
    for e in _device_ops(prof):
        c, us = acc.get(e.name, (0, 0.0))
        acc[e.name] = (c + 1, us + e.time_range.elapsed_us())
    return sorted(acc.items(), key=lambda kv: -kv[1][1])[:n]


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
    libs = cuda_build.build("gram", "track_iter", "deform", "zbuffer", "graph_if", "stamp",
                            "prev/gram", "prev/deform")
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


# the fused tracking iteration (`csrc/track_iter.cu`) at the main paths'
# shapes: (cell, W, H, level, bilinear); revisit's 4800 rows are its level 2
# at row stride 2 and its level 3 (also the SO3 level, 4800 x 8)
TRACK_SHAPES = [("revisit", 640, 480, 0, False), ("revisit", 640, 480, 1, False),
                ("revisit", 640, 480, 2, True), ("revisit", 640, 480, 3, True),
                ("mono", 1024, 320, 0, False)]
# both cells' step (`benchmark/configs/*.json`): 4 levels, row stride 2
TRACK_SETTINGS = dict(iterations=(4, 5, 10, 10), icp_weight=10.0, row_stride=2)


def _track_inputs(W: int, H: int, levels: int = 4):
    """Frame 6 against frame 5's pyramid on the revisit orbit with a W x H
    camera (fx = 528 W / 640), warm start ~1 cm / ~0.6 deg off the true
    motion: (model, frame, intrinsics, A0) on the CPU."""
    from densemonoslam_tpu_torch.utils import se3

    intr = CameraIntrinsics(528.0 * W / 640, 528.0 * W / 640, W / 2 - 0.5, H / 2 - 0.5)
    seq = SyntheticSequence(camera=CameraConfig(FrameResolution(W, H), intr, "track"),
                            num_frames=40, radius=0.35, max_angle=0.3)
    (rgb_m, d_m), (rgb_c, d_c) = seq.frame(5), seq.frame(6)
    rel = np.linalg.inv(seq.gt_pose(5)) @ seq.gt_pose(6)
    off = se3.se3_exp(torch.tensor([0.01, 0.0, -0.005, 0.01, -0.005, 0.0])).numpy()
    model = odometry.model_pyramid_from_frame(odometry.build_frame_pyramid(
        torch.from_numpy(rgb_m), torch.from_numpy(d_m), intr, levels))
    frame = odometry.build_frame_pyramid(torch.from_numpy(rgb_c), torch.from_numpy(d_c), intr,
                                         levels)
    return model, frame, intr, torch.from_numpy((off @ rel).astype(np.float32))


def _on(tree, dev):
    return type(tree)(*(tuple(x.to(dev) for x in field) for field in tree))


def _graph_replay(fn):
    """`fn` captured as a CUDA graph (run once on the capture stream first,
    so that K1's scratch for it exists); returns the graph's replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph.replay


def _count_ops(fn) -> tuple:
    """Device operations `fn` dispatches through PyTorch (views, allocations,
    host reads and profiler ranges left out), and what `fn` returned."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            skip = (func.is_view or func.namespace == "profiler"
                    or func in (torch.ops.aten.empty.memory_format,
                                torch.ops.aten._local_scalar_dense.default))
            Ops.n += 0 if skip else 1
            return func(*args, **(kwargs or {}))

    with Ops():
        out = fn()
    return Ops.n, out


def _plain_carry(c: torch.Tensor) -> tuple:
    """A fused GN carry as the plain composition's (A, stats, done)."""
    return (c[:16].view(4, 4), (c[16], c[17], c[18], c[19], c[20:56].view(6, 6)), c[56] != 0)


def _carry_check(what: str, fused: torch.Tensor, plain: tuple, P: int) -> float:
    """A fused iteration's carry against the plain composition's from the
    same carry, at the card test's tolerances (`tests/test_torch_cuda.py`,
    `_assert_carry_close`): the pose within 1e-5, the errors within 1e-4
    relative, the inlier counts within 2 + 5e-4 P rows (a gate value within
    an ulp of its threshold), JtJ within 5e-4 of its largest entry, `done`
    exactly.  Returns the pose's largest gap."""
    fused = fused.cpu()
    A, (e_i, n_i, e_r, n_r, JtJ), done = (x.cpu() if torch.is_tensor(x) else
                                          tuple(y.cpu() for y in x) for x in plain)
    err = float((fused[:16] - A.reshape(16)).abs().max())
    if not err < 1e-5:
        raise AssertionError(f"{what}: pose {err:.3e} from the plain chain's")
    for k, e in ((16, e_i), (18, e_r)):
        np.testing.assert_allclose(float(fused[k]), float(e), rtol=1e-4, err_msg=what)
    for k, n in ((17, n_i), (19, n_r)):
        if abs(float(fused[k]) - float(n)) > 2 + 5e-4 * P:
            raise AssertionError(f"{what}: inliers {float(fused[k]):.0f}, plain {float(n):.0f}")
    if float((fused[20:56] - JtJ.reshape(36)).abs().max()) > 5e-4 * float(JtJ.abs().max()):
        raise AssertionError(f"{what}: JtJ apart from the plain chain's")
    if bool(fused[56] != 0) != bool(done):
        raise AssertionError(f"{what}: done {bool(fused[56] != 0)}, plain {bool(done)}")
    return err


def phase_track_iter() -> dict:
    """The fused tracking iteration at each main-path shape: an exact and a
    frozen iteration each against the former chain (the same iteration op
    by op, K1 inside, on the card) from the same carry and sample; device
    times of the same two iterations, fused and the chain captured as a
    CUDA graph, beside K1's bound for the rows and the fused kernel's own;
    the SO3 pre-align likewise; then a whole track at the cells' settings
    against the plain track on the CPU: its pose, fused launches by mode
    and device operations, against the plain composition's operations."""
    from densemonoslam_tpu_torch.ops import track_iter

    times = {}
    inf, zero = torch.full((), float("inf"), device="cuda"), torch.zeros((), device="cuda")
    reset_counts()
    for cell, W, H, lv, bilinear in TRACK_SHAPES:
        model, frame, intr, A0 = _track_inputs(W, H)
        v, n, i = frame.vmap[lv], frame.nmap[lv], frame.intensity[lv]
        stride = 2 if i.numel() // 4 >= 4096 else 1
        lvl = odometry._Level(
            v_c=v.cuda()[::stride, ::stride], n_c=n.cuda()[::stride, ::stride],
            i_c=i.cuda()[::stride, ::stride], pack_m=model.pack[lv].cuda(), intr=intr.scaled(lv),
            bilinear=bilinear, icp_weight=10.0)
        P = lvl.i_c.numel()
        A0c = A0.cuda()
        start = (A0c, (inf, zero, inf, zero, torch.eye(6, device="cuda")),
                 torch.zeros((), dtype=torch.bool, device="cuda"))
        carry = torch.empty(track_iter.GN_CARRY, device="cuda")
        sample = torch.empty(P * track_iter.GN_SAMPLE, device="cuda")
        kw = dict(bilinear=bilinear, icp_weight=10.0, rgb_scale=odometry.RGB_UNIT_SCALE)
        args = (lvl.v_c, lvl.n_c, lvl.i_c, lvl.pack_m, lvl.intr)
        track_iter.gn_iteration(*args, A0c, carry, fresh=True, sample=sample, write_sample=True,
                                **kw)
        err = _carry_check(f"track_iter {cell} {P}x16 exact", carry,
                           odometry._exact_iters(lvl, start, 1), P)
        # a frozen iteration from the exact one's carry against the sample
        # kept at A0, fused and op by op
        fixed = carry.clone()
        fixed_plain = _plain_carry(fixed)
        u0, v0, _ = odometry.geometry.project(
            odometry.se3.transform_points(A0c, lvl.v_c.reshape(P, 3)), lvl.intr)
        smp = reductions.sample_model(lvl.pack_m, u0, v0, bilinear=bilinear)
        uv0 = torch.stack([u0, v0], -1)

        def chain_frozen():
            rows = reductions.joint_rows_frozen(lvl.v_c.reshape(P, 3), lvl.n_c.reshape(P, 3),
                                                lvl.i_c.reshape(P), smp, uv0, fixed_plain[0],
                                                lvl.intr)
            return odometry._advance(fixed_plain, *odometry._solve_iter(lvl, *rows))

        track_iter.gn_iteration(*args, fixed, carry, fresh=False, sample=sample, **kw)
        frozen_err = _carry_check(f"track_iter {cell} {P}x16 frozen", carry, chain_frozen(), P)

        fused = dict(
            exact=device_ms(lambda: track_iter.gn_iteration(*args, A0c, carry, fresh=True, **kw)),
            frozen=device_ms(lambda: track_iter.gn_iteration(*args, fixed, carry, fresh=False,
                                                             sample=sample, **kw)),
        )
        chain = dict(exact=device_ms(_graph_replay(lambda: odometry._exact_iters(lvl, start, 1))),
                     frozen=device_ms(_graph_replay(chain_frozen)))
        k1_ms, _ = bound_ms(4.0 * (P * 16 + 256), 2.0 * P * 256)
        Hm, Wm = lvl.pack_m.shape[:2]
        own = dict(exact=bound_ms(28.0 * P + 48.0 * Hm * Wm, 0)[0],
                   frozen=bound_ms(76.0 * P, 0)[0])
        times[(cell, P, 16)] = dict(fused_ms=fused, chain_ms=chain, k1_bound_ms=k1_ms,
                                    bound_ms=own, pose_err=max(err, frozen_err))
        log(f"[track_iter] {cell} {P:6d}x16 ({'bilinear' if bilinear else 'nearest'}): pose "
            f"{err:.2e} exact, {frozen_err:.2e} frozen from the chain's (stats and done "
            f"within the card test's tolerances); device a GN iteration: fused exact "
            f"{fused['exact'] * 1e3:7.2f} us, frozen {fused['frozen'] * 1e3:7.2f} us; the chain "
            f"in a graph: exact {chain['exact'] * 1e3:8.2f} us, frozen "
            f"{chain['frozen'] * 1e3:8.2f} us; bound: K1's rows {k1_ms * 1e3:5.2f} us, the fused "
            f"kernel's bytes exact {own['exact'] * 1e3:5.2f} / frozen {own['frozen'] * 1e3:5.2f} us")

    # the SO3 pre-align at revisit's coarsest level, ten iterations each way
    model, frame, intr, A0 = _track_inputs(640, 480)
    mc, fc, A0c = _on(model, "cuda"), _on(frame, "cuda"), A0.cuda()
    top = intr.scaled(3)
    fused_R = odometry._so3_prealign_fused(mc, fc, top, A0c)[:3, :3]
    plain_R = odometry._so3_prealign(mc, fc, top, A0c[:3, :3])
    torch.cuda.synchronize()
    so3_err = float((fused_R - plain_R).abs().max())
    if not so3_err < 1e-5:
        raise AssertionError(f"track_iter SO3: rotation {so3_err:.3e} from the plain chain's")
    so3 = dict(
        fused=device_ms(lambda: odometry._so3_prealign_fused(mc, fc, top, A0c)) / 10,
        chain=device_ms(_graph_replay(lambda: odometry._so3_prealign(mc, fc, top, A0c[:3, :3])))
        / 10,
        k1_bound=bound_ms(4.0 * (4800 * 8 + 64), 2.0 * 4800 * 64)[0],
    )
    times[("revisit", 4800, 8)] = so3
    log(f"[track_iter] revisit SO3 4800x8: rotation {so3_err:.2e} from the chain's; device an "
        f"iteration (mean of 10): fused {so3['fused'] * 1e3:7.2f} us, the chain in a graph "
        f"{so3['chain'] * 1e3:8.2f} us; K1's bound {so3['k1_bound'] * 1e3:5.2f} us")

    # gram(M)'s launches inside the chains above
    chain_k1 = counts()["gram"] - counts()["track_iter"]
    # a whole track at the cells' settings: launches and device operations
    tracks = {}
    for cell, W, H in (("revisit", 640, 480), ("mono", 1024, 320)):
        model, frame, intr, A0 = _track_inputs(W, H)
        mc, fc, A0c = _on(model, "cuda"), _on(frame, "cuda"), A0.cuda()
        odometry.track(mc, fc, A0c, intr, **TRACK_SETTINGS)
        reset_counts()
        ops, res = _count_ops(lambda: odometry.track(mc, fc, A0c, intr, **TRACK_SETTINGS))
        modes, fused_n, k1_n = by_mode(), klaunches.total("track_iter"), klaunches.total("gram")
        plain_ops, ref = _count_ops(lambda: odometry.track(model, frame, A0, intr,
                                                           **TRACK_SETTINGS))
        # the card test's tolerance: two f32 runs of 39 iterations
        dT = np.linalg.inv(ref.A.numpy()) @ res.A.cpu().numpy()
        dt_m = float(np.linalg.norm(dT[:3, 3]))
        dr_rad = float(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)))
        if not (dt_m < 1e-4 and dr_rad < 1e-4) or bool(res.failed) or bool(ref.failed):
            raise AssertionError(f"track_iter {cell} track: {dt_m:.3e} m, {dr_rad:.3e} rad from "
                                 f"the plain track on the CPU (failed {bool(res.failed)}, plain "
                                 f"{bool(ref.failed)})")
        tracked = graphs.GraphedFn(lambda A: odometry.track(mc, fc, A, intr, **TRACK_SETTINGS).A)
        track_ms = device_ms(lambda: tracked(A0c), n=20)
        tracks[cell] = dict(ops=ops, fused=fused_n, plain_ops=plain_ops, modes=modes,
                            track_ms=track_ms, pose_gap=(dt_m, dr_rad))
        log(f"[track_iter] {cell} track ({W}x{H}, {TRACK_SETTINGS}): pose {dt_m:.2e} m, "
            f"{dr_rad:.2e} rad from the plain track on the CPU; {fused_n} fused launches "
            f"{modes}, K1 launches {k1_n}, {ops} other device operations: {ops + fused_n} in all "
            f"against {plain_ops} for the plain composition (counted on the CPU); the track as "
            f"a graph {track_ms:.3f} ms of device time")
        if fused_n != k1_n or fused_n != 39 or ops + fused_n > 60:
            raise AssertionError(f"track_iter {cell}: {fused_n} fused launches, {k1_n} K1, "
                                 f"{ops} other operations")
    return dict(times=times, tracks=tracks, chain_k1=chain_k1)


def settle() -> None:
    """Wait for the device, then add the launches of the graphs' branch
    bodies that ran since the last settle (`graphs.settle_counts`)."""
    torch.cuda.synchronize()
    graphs.settle_counts()


def reset_counts() -> None:
    """Set every kernel's launch counts to 0 (just before a path is driven);
    launches inside branch bodies before this point are settled first, so
    that none lands in the next path's counts."""
    settle()
    klaunches.reset()


def counts() -> dict:
    """K1's, K2's, K3's, the stage stamp's and the fused tracking
    iteration's launches since the last `reset_counts`, settled."""
    settle()
    return dict(gram=klaunches.total("gram"), deform=klaunches.total("deform"),
                zbuffer=klaunches.total("zbuffer"), stamp=klaunches.total("stamp"),
                track_iter=klaunches.total("track_iter"))


def by_mode() -> dict:
    """Fused tracking iterations per mode since the last `reset_counts`."""
    settle()
    return dict(sorted(klaunches.by_shape("track_iter").items()))


def fused_check(label: str, launches: dict, modes: bool = True) -> None:
    """Every K1 launch of a leg was a fused tracking iteration: on the card
    `odometry.track` runs each iteration as one, and the plain `gram(M)`
    runs only in the kernel checks, after a leg's counts are read.  Logs
    the leg's fused launches by mode where this process counted them since
    the leg's reset (`modes`)."""
    log(f"[{label}] fused tracking iterations {launches['track_iter']} of {launches['gram']} "
        f"K1 launches" + (f", by mode {by_mode()}" if modes else ""))
    if launches["track_iter"] != launches["gram"]:
        raise AssertionError(f"{label}: {launches['gram']} K1 launches, "
                             f"{launches['track_iter']} of them fused iterations")


def by_shape() -> dict:
    """K1 launches per (P, C) since the last `reset_counts`, largest first."""
    settle()
    return dict(sorted(klaunches.by_shape("gram").items(), reverse=True))


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
    launches, shapes, stamps = counts()["gram"], by_shape(), counts()["stamp"]
    fused_iters = counts()["track_iter"]
    fused_check("phase 2", counts())
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
    return dict(launches=launches, fused=fused_iters, shapes=shapes, stamps=stamps, engine=eng,
                frames=frames)


def phase_profile(eng, frames) -> None:
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    frames_n = 4  # as STREET_PROFILED
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


def _open_loop_run(kind: str, camera, seq, frames) -> dict:
    """The open-loop leg at the headline configuration, `N_WARMUP` +
    `N_TIMED` frames, through the engine's graphed step ("graphed") or,
    as the eager reference run, with `step.make_step`'s step put in its
    place ("eager").  Wall ms a frame (host clock, synchronised at both
    ends), CUDA-event ms a frame over the same window, host syncs in the
    timed frames by source line, K1 launches (settled), graph counters,
    poses and ATE."""
    cfg = EngineConfig(**HEADLINE)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    if kind == "eager":
        fe.step_fn = stepmod.make_step(camera.intrinsics, RES[1], RES[0], cfg)
    fe.pose = seq.gt_pose(0).astype(np.float32)
    n = N_WARMUP + N_TIMED
    for i in range(N_WARMUP):
        eng.process_frame("cam0", *frames[i], float(i), sync=False)
    reset_counts()
    g0 = (graphs.CAPTURES, graphs.REPLAYS, graphs.STATE_COPIES)
    runs0 = dict(graphs.BRANCH_RUNS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            start.record()
            for i in range(N_WARMUP, n):
                eng.process_frame("cam0", *frames[i], float(i), sync=False)
            end.record()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    root = os.path.dirname(os.path.abspath(__file__))
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    out = dict(
        wall_ms=1e3 * dt / N_TIMED, event_ms=start.elapsed_time(end) / N_TIMED, syncs=syncs,
        launches=counts()["gram"], shapes=by_shape(), ifs=klaunches.total("graph_if"),
        stamps=counts()["stamp"],
        captures=graphs.CAPTURES - g0[0], replays=graphs.REPLAYS - g0[1],
        copies=graphs.STATE_COPIES - g0[2], branches=_runs_since(runs0),
    )
    est = [p for _, p in fe.trajectory]
    out["poses"] = np.stack(est)
    out["ate_mm"] = 1e3 * ate_rmse(est, [seq.gt_pose(i) for i in range(len(est))])
    if kind == "graphed":
        out["capture_s"] = fe.step_fn.graphed.capture_seconds
        eye = torch.eye(4, device="cuda")
        settle()
        runs0 = dict(graphs.BRANCH_RUNS)
        out["replay_ms"] = device_ms(
            lambda: fe.step_fn(fe.state, *frames[-1], eye, False, 1.0, 0.0), n=20)
        settle()
        out["replay_branches"] = _runs_since(runs0)
    return out


def _runs_since(before: dict) -> dict:
    """Branch bodies run since `before` (a copy of `graphs.BRANCH_RUNS`),
    by name; settle first."""
    return {k: v - before.get(k, 0) for k, v in sorted(graphs.BRANCH_RUNS.items())
            if v != before.get(k, 0)}


def _if_node_check() -> dict:
    """`csrc/graph_if.cu` against its plain version, the Python `if` of the
    eager program: a graph of one branch (y = 2x where the flag holds)
    replayed for each flag value against the `if`; then the device time of
    one IF node (a graph of 50 branches, flags false, replayed behind a
    spin kernel) beside the host read the `if` costs."""
    x = torch.arange(1024, dtype=torch.float32, device="cuda")

    def one(flag, x):
        y = x.clone()
        graphs.branch(flag, lambda: y.mul_(2.0), "check")
        return y

    fn = graphs.GraphedFn(one)
    err = 0.0
    for flag in (True, False, True):
        y = fn(flag, x)
        want = x * 2.0 if flag else x
        err = max(err, float((y - want).abs().max()))
    if err != 0.0:
        raise AssertionError(f"IF node: {err} from the plain if")
    flags = torch.zeros(50, dtype=torch.bool, device="cuda")

    def many(flags, x):
        y = x.clone()
        for k in range(50):
            graphs.branch(flags[k], lambda: y.add_(1.0), "check")
        return y

    fn50 = graphs.GraphedFn(many)
    fn50(flags, x)
    ms = device_ms(lambda: fn50(flags, x), n=20) / 50
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    plain = call_ms(lambda: bool(flag))
    b_ms, b_by = bound_ms(1, 0)  # one flag byte read
    log(f"[graphs] IF node against the plain if: max|err| {err}; device {ms * 1e3:.3f} us per "
        f"node (condition setter + node, from a graph of 50), plain if {plain * 1e3:.2f} us "
        f"(a host read), bound {b_ms * 1e3:.6f} us ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)



def _stamp_check() -> dict:
    """`csrc/stamp.cu` against its plain version, the CPU `StageRing`: both
    rings stamped with the same ticks and slots, ticks past the ring's
    length included (their rows wrap onto earlier frames'); the tick tags
    equal, each row's times in the order its stamps were taken, and the
    frames both read as complete (`StageRing.intervals`) the same.  Then the
    device time of one stamp (a graph of 50, replayed behind a spin kernel)
    beside the CPU ring's write."""
    slots, n_ring = 7, timer.RING_FRAMES
    card, plain = timer.StageRing(slots), timer.StageRing(slots)
    rng = np.random.default_rng(7)
    ticks = [0, 1, 2, 5, n_ring - 1, n_ring, n_ring + 1, n_ring + 5, 2 * n_ring + 2,
             3 * n_ring - 1, 5 * n_ring + 1]
    order = []  # (row, tick, slot) in the order the stamps were taken
    for k in ticks:
        taken = np.sort(rng.choice(slots, size=int(rng.integers(1, slots + 1)), replace=False))
        if k % 3 == 0:
            taken = np.arange(slots)  # some frames take every stamp
        for slot in taken.tolist():
            card.stamp(slot, torch.tensor(k, dtype=torch.int64, device="cuda"))
            plain.stamp(slot, torch.tensor(k, dtype=torch.int64))
            order.append((k % n_ring, k, slot))
    a, b = card.read(), plain.read()
    tag_err = int(np.abs(a[..., 1] - b[..., 1]).max())
    if tag_err != 0:
        raise AssertionError(f"stamp: tick tags differ from the CPU ring's by up to {tag_err}")
    for row in sorted({r for r, _, _ in order}):
        # the stamps that kept their slot, in the order they were taken
        kept = [(k, slot) for r, k, slot in order if r == row and a[row, slot, 1] == k]
        t = np.array([a[row, slot, 0] for _, slot in kept])
        if not (t > 0).all() or (np.diff(t) < 0).any():
            raise AssertionError(f"stamp: row {row}'s times out of stamp order: {kept} {t}")
    for lo, hi in ((0, slots - 1), (1, 3), (2, 5)):
        ka = [k for k, _ in card.intervals(lo, hi, a)]
        kb = [k for k, _ in plain.intervals(lo, hi, b)]
        if ka != kb:
            raise AssertionError(f"stamp: frames with slots {lo} and {hi}: {ka} != {kb}")
    tick = torch.zeros((), dtype=torch.int64, device="cuda")
    ring = timer.StageRing(slots)
    ring.allocate(tick.device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for j in range(50):
            ring.stamp(j % slots, tick)
    ms = device_ms(g.replay, n=20) / 50
    cpu_tick = torch.zeros((), dtype=torch.int64)
    plain_ms = call_ms(lambda: plain.stamp(3, cpu_tick))
    b_ms, b_by = bound_ms(24, 0)  # the 8-byte tick read, the 16-byte stamp written
    log(f"[graphs] stage stamp against the CPU ring: {len(order)} stamps over {len(ticks)} "
        f"ticks (up to {ticks[-1]}, ring {n_ring} frames), tick tags equal, each row's times "
        f"in stamp order; device {ms * 1e3:.3f} us per stamp (from a graph of 50), CPU ring "
        f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.6f} us ({b_by})")
    return dict(max_abs_err=float(tag_err), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)

def phase_graphs() -> dict:
    """The open-loop leg eager and graphed in alternating pairs (eager,
    graphed, graphed, eager; `tools/bench_pairs.py`'s method): wall and
    CUDA-event ms a frame, a replay's device ms, host syncs by source line,
    captures, replays, state copies, capture seconds, the largest pose
    difference between the runs and both ATEs.  The graphed runs must make
    no host sync in the step, launch K1 as often as the eager ones and copy
    no state in; their poses must lie within 1e-4 m of the eager run's (or
    twice the two eager runs' own difference, if larger), both ATEs < 10 mm."""
    camera = _camera()
    n = N_WARMUP + N_TIMED
    seq = SyntheticSequence(camera=camera, num_frames=n, radius=0.12, max_angle=0.12)
    frames = [tuple(torch.from_numpy(x).cuda() for x in seq.frame(i)) for i in range(n)]
    runs = []
    for kind in ("eager", "graphed", "graphed", "eager"):
        r = _open_loop_run(kind, camera, seq, frames)
        runs.append((kind, r))
        top = ", ".join(f"{k} {v / N_TIMED:.2f}" for k, v in r["syncs"].most_common(6))
        log(f"[graphs] {kind}: wall {r['wall_ms']:.2f} ms/frame, CUDA events "
            f"{r['event_ms']:.2f} ms/frame, ATE {r['ate_mm']:.4f} mm, K1 launches "
            f"{r['launches']}, IF setters {r['ifs']}, captures {r['captures']}, replays "
            f"{r['replays']}, state copies {r['copies']}; host syncs a frame by line: "
            f"{top or 'none'}; branch bodies run in the timed frames: {r['branches']}")
        if kind == "graphed":
            log(f"[graphs] graphed: capture {r['capture_s']:.3f} s, one replay's device time "
                f"{r['replay_ms']:.3f} ms (20 replays behind a spin kernel after 2 more; branch "
                f"bodies run over the 22: {r['replay_branches']})")
    eager = [r for k, r in runs if k == "eager"]
    graphed = [r for k, r in runs if k == "graphed"]

    def pose_diff(a, b):
        return float(np.abs(a["poses"][:, :3, 3] - b["poses"][:, :3, 3]).max())

    eager_diff = pose_diff(*eager)
    bound = max(1e-4, 2 * eager_diff)
    diff = max(pose_diff(g, e) for g in graphed for e in eager)
    in_step = {k: v for g in graphed for k, v in g["syncs"].items()
               if k.startswith(("densemonoslam_tpu_torch/step.py",
                                "densemonoslam_tpu_torch/utils/graphs.py",
                                "densemonoslam_tpu_torch/tracking/"))}
    wall = {k: [r["wall_ms"] for kk, r in runs if kk == k] for k in ("eager", "graphed")}
    log(f"[graphs] pairs: eager {wall['eager']} ms/frame, graphed {wall['graphed']} ms/frame "
        f"(fps {[round(1e3 / w, 2) for w in wall['eager']]} / "
        f"{[round(1e3 / w, 2) for w in wall['graphed']]}); largest pose difference graphed "
        f"against eager {diff * 1e3:.6f} mm (bound {bound * 1e3:.4f} mm; eager against eager "
        f"{eager_diff * 1e3:.6f} mm); host syncs in the step's replays {sum(in_step.values())}")
    if in_step:
        raise AssertionError(f"host syncs inside the graphed step: {in_step}")
    if not diff <= bound:
        raise AssertionError(f"graphed poses {diff} m from the eager run's (bound {bound})")
    for kind, r in runs:
        if not r["ate_mm"] < 10.0:
            raise AssertionError(f"{kind} run: ATE {r['ate_mm']:.3f} mm")
    if any(g["launches"] != e["launches"] for g in graphed for e in eager):
        raise AssertionError(f"K1 launches through replays {[g['launches'] for g in graphed]} "
                             f"!= eager {[e['launches'] for e in eager]}")
    if any(g["copies"] or g["captures"] or g["replays"] != N_TIMED for g in graphed):
        raise AssertionError("graphed timed frames: a capture, a state copy or a frame "
                             f"without its replay: {[(g['captures'], g['replays'], g['copies']) for g in graphed]}")
    if_check = _if_node_check()
    stamp_check = _stamp_check()
    return dict(runs=runs, diff=diff, bound=bound, eager_diff=eager_diff, if_check=if_check,
                ifs=sum(g["ifs"] for g in graphed), stamp_check=stamp_check,
                stamps=sum(r["stamps"] for _, r in runs))


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
    # positions round relative to their size: DEFORM_TOL up to 10 m, in
    # proportion beyond (a street map spans hundreds of metres)
    pos_tol = DEFORM_TOL * max(1.0, float(data[:n, sm.POS].abs().max()) / 10.0)
    if not (err_p <= pos_tol and err_n <= DEFORM_TOL):
        raise AssertionError(f"deform {label}: max|err| pos {err_p:.3e} (tolerance "
                             f"{pos_tol:.1e}) normal {err_n:.3e}")
    out_v = prev_deform(data.clone(), count, graph)
    torch.cuda.synchronize()
    diff_v = (out_v - out_p).abs()
    err_vp = float(diff_v[:, sm.POS].max())
    diff_v[:, sm.POS] = 0.0
    err_vr = float(diff_v.max())
    if not (err_vp <= pos_tol and err_vr <= DEFORM_TOL):
        raise AssertionError(f"deform {label}: previous design's max|err| pos {err_vp:.3e}, "
                             f"other columns {err_vr:.3e}")
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
    return dict(label=label, rows=data.shape[0] - 1, live=n_alive, nodes=K,
                max_abs_err=max(err_p, err_n), ms=k_dev, prev_ms=v_dev, plain_ms=p_dev,
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


def _synthetic_deform_case():
    """A random 1<<20-row map and a 512-node graph (a few invalid nodes
    inside, the last 32 invalid), times with ties, 10% dead rows and live
    rows past `count`: (data, count, graph) on the card."""
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
    return d, count, graph


# K3 at the revisit window's end: a 1<<25-row map with ~15 M rows in use
# (PERF.md §4), rendered at 640x480 with rgbd_vga's camera
K3_ROWS, K3_LIVE, K3_TIME, K3_TIME_DELTA = 1 << 25, 15_000_000, 100.0, 30
K3_INTR, K3_W, K3_H = CameraIntrinsics(528.0, 528.0, 319.5, 239.5), 640, 480
K3_FLOAT_RTOL = 1e-6
K3_MODES = (("inactive", splat.MODE_INACTIVE), ("all", splat.MODE_ALL),
            ("active", splat.MODE_ACTIVE))


def _k3_map() -> tuple:
    """(data, count, pose) on the card: a K3_ROWS-row map whose K3_LIVE rows
    in use are surfels 0.3-8 m in front of the pose's camera (a 20th behind
    it, a margin outside the image), a 10th of them dead, last seen over the
    100 ticks before K3_TIME (about 70% outside the time window); the rows
    above the count look alive and lie nearer, so a render that read one
    would show it."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    a, b = 0.3, -0.2
    R = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     dtype=torch.float64) @ torch.tensor(
        [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]], dtype=torch.float64)
    pose = torch.eye(4, dtype=torch.float64)
    pose[:3, :3] = R
    pose[:3, 3] = torch.tensor([0.4, -0.3, 1.1], dtype=torch.float64)
    pose = pose.to(torch.float32).to(dev)
    n = K3_ROWS + 1
    data = torch.zeros((n, sm.COLS), dtype=torch.float32, device=dev)
    z = uniform(0.3, 8.0, n)
    z[K3_LIVE:] = uniform(0.06, 0.29, n - K3_LIVE)
    z = torch.where(uniform(0, 1, n) < 0.05, -z, z)
    u, v = uniform(-30, K3_W + 30, n), uniform(-30, K3_H + 30, n)
    i = K3_INTR
    p_cam = torch.stack([(u - i.cx) / i.fx * z, (v - i.cy) / i.fy * z, z], -1)
    n_cam = torch.stack([0.3 * torch.randn(n, generator=gen, device=dev),
                         0.3 * torch.randn(n, generator=gen, device=dev),
                         -torch.ones(n, device=dev)], -1)
    n_cam = n_cam / n_cam.norm(dim=-1, keepdim=True)
    data[:, sm.POS] = p_cam @ pose[:3, :3].T + pose[:3, 3]
    data[:, sm.CONF] = torch.where(uniform(0, 1, n) < 0.1, -1.0, uniform(0.5, 10.0, n))
    data[:, 4:7] = uniform(0, 255, n, 3)
    data[:, sm.RADIUS] = uniform(0.002, 0.03, n)
    data[:, sm.NORMAL] = n_cam @ pose[:3, :3].T
    data[:, 12] = uniform(0, K3_TIME, n)
    data[K3_LIVE:, sm.CONF] = 5.0
    count = torch.full((), K3_LIVE, dtype=torch.int64, device=dev)
    return data, count, pose


def phase_zbuffer() -> dict:
    """K3 (`csrc/zbuffer.cu`) against the op-by-op exact path
    (`splat.render_ops`) on `_k3_map`, in each mode: index and cell equal on
    every pixel, no row at or above the count shown, the float maps within
    K3_FLOAT_RTOL relative; two kernels and a memset a call; then, in the
    loop check's INACTIVE mode, device times of the kernel, of
    `splat.render`'s whole call (the inverse pose and the tick's scalar
    with it) and of the plain path, beside the bound: every row below the
    count read once (both its sectors, 64 bytes), the key buffer set, read
    once, the winning row of each drawn pixel read once and the prediction
    written once, at 3.35 TB/s."""
    data, count, pose = _k3_map()
    t_now = torch.full((), K3_TIME, device="cuda")
    tinv = se3mod.se3_inverse(pose)
    n_live = int(count)
    worst, out = 0.0, {}
    for name, mode in K3_MODES:
        args = (data, count, pose, K3_INTR, K3_W, K3_H, t_now)
        kw = dict(time_delta=K3_TIME_DELTA, mode=mode)
        k, p = splat.render(*args, **kw), splat.render_ops(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(k.index, p.index) and torch.equal(k.cell, p.cell)):
            bad = int((k.cell != p.cell).sum()) + int((k.index != p.index).sum())
            raise AssertionError(f"zbuffer {name}: {bad} cells or pixels won by another row")
        if int(k.cell.max()) >= n_live or int(k.index.max()) >= n_live:
            raise AssertionError(f"zbuffer {name}: a row at or above the count was drawn")
        rel = 0.0
        for field, t in k._asdict().items():
            if t.dtype == torch.float32:
                ref = p._asdict()[field]
                rel = max(rel, float(((t - ref).abs() / ref.abs().clamp_min(1e-30)).max()))
        if rel > K3_FLOAT_RTOL:
            raise AssertionError(f"zbuffer {name}: float maps {rel:.3e} apart, relative")
        worst = max(worst, rel)
        drawn = int((k.index >= 0).sum())
        out[name] = dict(drawn=drawn, cells=int((k.cell >= 0).sum()), rel_err=rel)
        log(f"[zbuffer] {name}: {drawn} pixels drawn, {out[name]['cells']} cells won; "
            f"index and cell equal to the exact path's, floats within {rel:.3e} relative")
        del k, p
    kw = dict(time_delta=K3_TIME_DELTA, mode=splat.MODE_INACTIVE, splat_k=3, depth_max=100.0)
    kernel = lambda: zbuffer.render_full(  # noqa: E731
        data, count, tinv, t_now, K3_INTR, K3_W, K3_H, **kw)
    whole = lambda: splat.render(data, count, pose, K3_INTR, K3_W, K3_H, t_now, **kw)  # noqa: E731
    plain = lambda: splat.render_ops(data, count, pose, K3_INTR, K3_W, K3_H, t_now, **kw)  # noqa: E731
    per_call, ops = cuda_build.kernels_per_call(kernel)
    if (per_call, ops) != (2, 3):
        raise AssertionError(f"zbuffer: one call enqueued {per_call} kernels in {ops} device "
                             f"operations, not a memset and two kernels")
    k_dev, r_dev, p_dev = device_ms(kernel, n=20), device_ms(whole, n=20), device_ms(plain, n=3)
    hw, drawn = K3_W * K3_H, out["inactive"]["drawn"]
    b_ms, b_by = bound_ms(64.0 * n_live + hw * (8 + 8 + 68) + 64.0 * drawn, 0.0)
    log(f"[zbuffer] inactive, {n_live} rows below the count of {K3_ROWS}: device: kernel "
        f"{k_dev * 1e3:.2f} us ({per_call:g} kernels + a memset a call), splat.render "
        f"{r_dev * 1e3:.2f} us, plain {p_dev * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})")
    return dict(rows=K3_ROWS, live=n_live, modes=out, max_rel_err=worst, ms=k_dev,
                render_ms=r_dev, plain_ms=p_dev, bound_ms=b_ms, bound_by=b_by,
                launches_per_call=per_call)


class _RenderedOnce:
    """A synthetic sequence whose frames are rendered once and kept: the leg
    drives the same orbit four times."""

    def __init__(self, seq: SyntheticSequence):
        self.seq, self.camera, self.frames = seq, seq.camera, {}

    def frame(self, i: int):
        if i not in self.frames:
            self.frames[i] = self.seq.frame(i)
        return self.frames[i]

    def gt_pose(self, i: int) -> np.ndarray:
        return self.seq.gt_pose(i)


def _rows_block(seq: SyntheticSequence) -> list:
    """One 640x480 level's unpacked ICP and RGB rows, [307200, 8] each:
    frame 1 against frame 0's maps at the true relative pose."""
    intr = seq.camera.intrinsics
    pyr = [odometry.build_frame_pyramid(*(torch.from_numpy(x).cuda() for x in seq.frame(i)),
                                        intr, 1) for i in (0, 1)]
    A = torch.from_numpy(
        (np.linalg.inv(seq.gt_pose(0)) @ seq.gt_pose(1)).astype(np.float32)).cuda()
    m, c = pyr
    return [
        reductions.icp_rows(c.vmap[0], c.nmap[0], m.vmap[0], m.nmap[0], A, intr),
        reductions.rgb_rows(c.vmap[0], c.intensity[0], m.intensity[0], m.grad_x[0],
                            m.grad_y[0], A, intr, depth_m=m.vmap[0][..., 2]),
    ]


def phase_odometry() -> dict:
    """The odometry leg: `examples/torch_run_synthetic.py`'s frame-to-frame
    path at 640x480 (fps, ATE, failures, K1 launches by shape, device-busy
    ms per frame), its full-engine mode, one 307200x8 block of the unpacked
    rows through K1 against `gram_reference`, and the batched pose history
    against a flush after every frame."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    mod = _example("torch_run_synthetic")
    camera = _camera()
    seq = _RenderedOnce(SyntheticSequence(camera=camera, num_frames=ODO_FRAMES, radius=0.35,
                                          max_angle=0.3))
    for i in range(ODO_FRAMES):
        seq.frame(i)
    reset_counts()  # count only this path's launches from here
    odo = mod.run_odometry(seq, ODO_FRAMES, "cuda", levels=ODO_LEVELS)
    f2f = counts()["gram"]
    per_pair = sum(odometry.ITERATIONS_DEFAULT) + odometry.SO3_ITERATIONS
    stages = {k: round(v, 2) for k, v in odo["timer"].summary().items()}
    log(f"[odometry] {ODO_FRAMES} frames at {RES[0]}x{RES[1]}, {ODO_LEVELS} levels: "
        f"{odo['fps']:.2f} fps (frames 2..{ODO_FRAMES - 1}, synchronised), ATE "
        f"{odo['ate'] * 1e3:.4f} mm, tracking failures {odo['failures']}; stage means (ms) "
        f"{stages}")
    log(f"[odometry] gram launches {f2f} ({f2f / (ODO_FRAMES - 1):.2f} per tracked frame) by "
        f"(P, C): {by_shape()}")
    if odo["failures"] or not odo["ate"] < ODO_ATE_M:
        raise AssertionError(f"odometry: {odo['failures']} failures, ATE "
                             f"{odo['ate'] * 1e3:.3f} mm (bound {ODO_ATE_M * 1e3:.0f} mm)")
    if f2f < (ODO_FRAMES - 1) * per_pair:
        raise AssertionError(f"odometry: {f2f} gram launches < {ODO_FRAMES - 1} tracked "
                             f"frames x {per_pair} SO3+GN iterations")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mod.run_odometry(seq, ODO_PROFILED, "cuda", levels=ODO_LEVELS)
    busy, ops = _device_us(prof)
    log(f"[odometry] {ODO_PROFILED} frames under the profiler ({ODO_PROFILED} pyramids, "
        f"{ODO_PROFILED - 1} tracks): device busy {busy / 1e3 / (ODO_PROFILED - 1):.3f} ms "
        f"per tracked frame, {ops / (ODO_PROFILED - 1):.0f} device ops per tracked frame")

    lit = mod.run_odometry(seq, ODO_FRAMES, "cuda")
    log(f"[odometry] the example's own {mod.LEVELS} levels at {RES[0]}x{RES[1]}: "
        f"{lit['fps']:.2f} fps, ATE {lit['ate'] * 1e3:.4f} mm, tracking failures "
        f"{lit['failures']} (reported, not bounded)")
    if not np.isfinite(lit["ate"]):
        raise AssertionError("odometry at 3 levels: non-finite poses")

    gram_before = counts()["gram"]
    slam = mod.run_slam(seq, ODO_FRAMES, "cuda")
    slam_launches = counts()["gram"] - gram_before
    log(f"[odometry] full engine (the example's EngineConfig) on the same orbit: "
        f"{slam['fps']:.2f} fps, ATE {slam['ate'] * 1e3:.4f} mm, frames not tracked "
        f"{slam['failed']}, surfels {slam['surfels']}, gram launches {slam_launches} "
        "(reported, not bounded: the example's 3 levels and 1<<18-surfel map are sized "
        "for 160x120)")
    if not np.isfinite(slam["ate"]):
        raise AssertionError("the example's full engine: non-finite poses")
    del slam
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        history_run = _repo_module(os.path.join("tests", "torch_closed_loop.py")).history_run
        runs = [history_run(tmp, tag, flush, "cuda")
                for tag, flush in (("batched", False), ("each", True), ("batched_again", False))]
    launches = counts()
    shapes = by_shape()
    fused_check("odometry", launches)
    batched, each, _ = runs
    same = dict(
        trajectory=all(np.array_equal(r["traj"], batched["traj"]) for r in runs),
        ticks=all(np.array_equal(r["ticks"], batched["ticks"]) for r in runs),
        checkpoint=all(r["ckpt"].keys() == batched["ckpt"].keys()
                       and all(np.array_equal(r["ckpt"][k], batched["ckpt"][k])
                               for k in batched["ckpt"]) for r in runs),
    )
    flushes = [i for i, w in enumerate(batched["writes"]) if w]
    log(f"[odometry] pose history, batched vs a flush after every frame vs batched again "
        f"(closed-loop scenario, {len(batched['writes'])} frames, a loop closed in each): "
        f"bit-identical {same}")
    log(f"[odometry] history writes per frame: batched {batched['writes']} (record_pose 0 "
        f"on {len(batched['writes']) - len(flushes)} frames; flushes on frames {flushes}, "
        f"where the loop check read the history); flushed every frame {each['writes']}")
    if not all(same.values()):
        raise AssertionError(f"batched pose history differs from per-frame flushing: {same}")
    if set(batched["writes"]) - {0, 2} or each["writes"] != [2] * len(each["writes"]):
        raise AssertionError("history writes are not 0 between flushes and 2 per flush")
    log(f"[odometry] the leg's launches: gram {launches['gram']}, deform {launches['deform']}; "
        f"gram by (P, C): {shapes}")

    # one level of unpacked rows through K1, after the counts are read
    # (launches that compare a kernel with its plain version do not count)
    # The tolerance is for rows of unit size (test_pallas.py's normal rows):
    # each column is scaled by the power of two nearest its largest entry,
    # which is exact in f32 and leaves the kernel's rounding as it is; the
    # RGB block's entries reach 1e12 unscaled, where f32's cancellation
    # alone is 2e-5 of an off-diagonal entry
    block_err, n0 = 0.0, klaunches.total("gram")
    for name, M in zip(("icp_rows", "rgb_rows"), _rows_block(seq)):
        col = M.abs().amax(dim=0).clamp(min=1e-30)
        M = M * torch.exp2(-torch.round(torch.log2(col)))
        out = gram.gram(M)
        ref = gram.gram_reference(M.double())
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **GRAM_TOL)
        err = float((out.double() - ref).abs().max())
        block_err = max(block_err, err)
        log(f"[odometry] K1 on the {name} block {tuple(M.shape)} ({int(M[:, 7].sum().item())} "
            f"rows kept, columns scaled to unit size): max|err| {err:.3e} against "
            f"gram_reference in f64, within rtol {GRAM_TOL['rtol']} / atol {GRAM_TOL['atol']}")
    return dict(launches=launches, shapes=shapes, fps=odo["fps"], ate_mm=1e3 * odo["ate"],
                block_err=block_err, block_launches=klaunches.total("gram") - n0)


def phase_deform_synthetic() -> dict:
    """K2 on `_synthetic_deform_case`'s map and graph; then the all-invalid
    graph must pass every row through bit for bit."""
    d, count, graph = _synthetic_deform_case()
    K = graph.pos.shape[0]
    res = _deform_checks("synthetic 1<<20 rows, 512 nodes", d, count, graph)
    out = deform.deform_map(d.clone(), count, dg.empty_graph(K))
    torch.cuda.synchronize()
    if not torch.equal(out, d):
        raise AssertionError("deform: rows without support did not pass through unchanged")
    log("[deform] all-invalid graph: every row passed through bit for bit")
    return res


def _profile_closure(eng, fe, frames: list, start: int, interval: int) -> None:
    """Frames from `start` on, with each loop-check frame alone under
    `torch.profiler`, until a check closes a loop (at most three checks):
    the host wall time of each `loop.*` stage of that check, and the device
    time of the kernels launched inside it.  The leg's earlier closures have
    run by then, so the stage times are steady-state."""
    from torch.profiler import ProfilerActivity, profile

    i = start
    for _ in range(3):
        while (fe.tick + 1) % interval:  # the frame before a loop-check tick
            eng.process_frame("cam0", *frames[i % len(frames)], float(i), sync=False)
            i += 1
        c0 = fe.loops_closed
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.process_frame("cam0", *frames[i % len(frames)], float(i), sync=False)
            torch.cuda.synchronize()
        i += 1
        if fe.loops_closed > c0:
            break
    log(f"[closure profile] the loop check of frame {i - 1} (tick {fe.tick}, after the timed "
        f"frames), {fe.loops_closed - c0} closed:")
    for key, (calls, dev_ms, host_ms) in sorted(_range_device_ms(prof, "loop.").items()):
        log(f"[closure profile] {key:20s} {calls:2d} calls, host wall {host_ms / calls:9.2f} "
            f"ms/call, device {dev_ms / calls:8.2f} ms/call")


def phase_closed_loop() -> dict:
    """The closed-loop leg at full width; per-frame wall time and host syncs
    separate the loop-check frames from the others.  After the timed frames
    one closure is profiled by stage (`_profile_closure`), then each GN-CG
    call of the leg is held against the eager function (`_gncg_checks`);
    the map and graph returned for K2's check are those of the timed
    frames' end."""
    camera = _camera()
    seq = SyntheticSequence(camera=camera, num_frames=LAP, radius=0.35, max_angle=0.3)
    frames = [tuple(torch.from_numpy(x).cuda() for x in seq.frame(i)) for i in range(LAP)]
    cfg = EngineConfig(**CLOSED)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    # every GN-CG call's inputs, for `_gncg_checks` after the leg
    calls, graphed = [], dg.optimise_graphed

    def recording(graph, cons, frozen=None, iters=dg.GN_ITERS, cg_iters=dg.CG_ITERS, rel=None):
        calls.append(tuple(None if x is None else type(x)(*(t.clone() for t in x))
                           if isinstance(x, tuple) else x.clone() for x in (graph, cons, frozen, rel)))
        return graphed(graph, cons, frozen, iters, cg_iters, rel)

    dg.optimise_graphed = recording
    try:
        out = _closed_loop_leg(camera, seq, frames, cfg, eng, fe)
    finally:
        dg.optimise_graphed = graphed
    out["gncg"] = _gncg_checks(calls)
    return out


def _gncg_checks(calls: list) -> list:
    """Each GN-CG call of the closed-loop leg again on its recorded inputs,
    graphed (the leg's graph replayed) and eager (the eager reference run,
    `deformation.optimise`): the largest difference of the node transforms
    A and t (bound 1e-5), the energies, wall ms (synchronised) and
    CUDA-event ms of each, and the graph's device ms a call (replays behind
    a spin kernel)."""
    rows = []
    for k, (graph, cons, frozen, rel) in enumerate(calls):
        res = {}
        for kind, fn in (("graphed", dg.optimise_graphed), ("eager", dg.optimise)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out, st = fn(graph, cons, frozen=frozen, rel=rel)
            end.record()
            torch.cuda.synchronize()
            res[kind] = (out, st, 1e3 * (time.perf_counter() - t0), start.elapsed_time(end))
        (g, gs, g_wall, g_ev), (e, es, e_wall, e_ev) = res["graphed"], res["eager"]
        diff = max(float((g.A - e.A).abs().max()), float((g.t - e.t).abs().max()))
        dev = device_ms(lambda: dg.optimise_graphed(graph, cons, frozen=frozen, rel=rel), n=5)
        row = dict(diff=diff, energies=[float(x) for x in (*gs, *es)], graphed_wall_ms=g_wall,
                   graphed_event_ms=g_ev, graphed_device_ms=dev, eager_wall_ms=e_wall,
                   eager_event_ms=e_ev)
        rows.append(row)
        log(f"[closed] GN-CG call {k}: graphed against eager max|dA, dt| {diff:.3e}; energies "
            f"(initial, final, mean constraint error) graphed "
            f"{[round(x, 6) for x in row['energies'][:3]]}, eager "
            f"{[round(x, 6) for x in row['energies'][3:]]}; wall graphed {g_wall:.2f} / eager "
            f"{e_wall:.2f} ms, CUDA events {g_ev:.2f} / {e_ev:.2f} ms, the graph's device "
            f"{dev:.2f} ms")
    if not rows:
        raise AssertionError("the closed-loop leg ran no GN-CG")
    worst = max(r["diff"] for r in rows)
    if not worst < 1e-5:
        raise AssertionError(f"graphed GN-CG node transforms {worst} from the eager ones")
    return rows


def _closed_loop_leg(camera, seq, frames, cfg, eng, fe) -> dict:
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
    launches = counts()
    shapes = by_shape()
    fused_check("closed loop", launches)
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
    out = dict(launches=launches, shapes=shapes, graph=fe.last_loop_graph, data=m.data.clone(),
               count=m.count.clone(), ate_mm=1e3 * ate, loops_timed=loops_timed,
               loops_all=fe.loops_closed, surfels=surfels)
    _profile_closure(eng, fe, frames, CL_WARMUP + CL_TIMED, cfg.loop_check_interval)
    return out


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
        before = counts()["gram"]
        calls.append(relocalise(*a, **k))
        in_reloc.append(counts()["gram"] - before)
        return calls[-1]

    def starved():
        """Tracking levels redone after starving (`graphs.branch` runs of
        the `starved<level>` fallbacks, in the step and in relocalisation)."""
        settle()
        return sum(n for k, n in graphs.BRANCH_RUNS.items() if k.startswith("starved"))

    eng.relocalise = counting
    per_frame = []  # (gram launches, of them inside relocalisation, levels redone)
    reset_counts()  # count only this path's launches from here
    for i in range(30):
        n0, r0, s0 = counts()["gram"], sum(in_reloc), starved()
        eng.process_frame("cam0", *seq.frame(i % 16), float(100 + i))
        per_frame.append((counts()["gram"] - n0, sum(in_reloc) - r0, starved() - s0))
    launches, shapes, stamps = counts()["gram"], by_shape(), counts()["stamp"]
    fused = counts()["track_iter"]
    fused_check("reloc", counts())
    err = float(np.linalg.norm(fe.pose[:3, 3] - seq.gt_pose(15)[:3, 3]))
    log(f"[reloc] {ferns} fern keyframes; {len(calls)} relocalisation attempts, "
        f"{sum(calls)} accepted; final pose {err:.3f} m from the map's last ground-truth pose")
    log(f"[reloc] gram launches: {launches} in the 30 frames after the teleport, "
        f"{sum(in_reloc)} of them inside relocalisation attempts")
    log(f"[reloc] per frame (gram launches, of them in relocalisation, tracking levels "
        f"redone after starving): {per_frame}")
    log(f"[reloc] gram launches by (P, C): {shapes}")
    if ferns < 1:
        raise AssertionError("no fern keyframe stored")
    if not any(calls):
        raise AssertionError(f"no relocalisation accepted ({len(calls)} attempts)")
    if sum(launches for ok, launches in zip(calls, in_reloc) if ok) == 0:
        raise AssertionError("an accepted relocalisation launched no gram kernel")
    if not err < 1.0:
        raise AssertionError(f"pose still {err:.2f} m from the map")
    return dict(launches=launches, fused=fused, shapes=shapes, stamps=stamps)


def _street_sequence() -> StreetSequence:
    return StreetSequence(CameraConfig.kitti_default(), num_frames=STREET_FRAMES,
                          exposure_jitter=0.03)


def _repo_module(relpath: str):
    """A module of this checkout that is not a package module (an example
    entry point, a test scenario), loaded from its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name: str):
    """An example entry point of the port (`examples/<name>.py`) as a module."""
    return _repo_module(os.path.join("examples", f"{name}.py"))


def _render_sets() -> dict:
    """Every sequence whose frames the host renders in the background, by
    name: the mono leg's lap, then the train leg's (the trainers' own
    `sequences()`)."""
    syn = _example("torch_train_depthnet").sequences()
    laps, kitti = _example("torch_train_depthnet_street").sequences()
    return {"mono": _street_sequence(), **{f"train_syn{k}": s for k, s in enumerate(syn)},
            **{f"train_street{k}": s for k, s in enumerate(laps)}, "train_kitti": kitti}


def _frame_arrays(buf, seq) -> tuple[np.ndarray, np.ndarray]:
    """The [N, H, W, 3] u8 RGB and [N, H, W] f32 depth views of one buffer."""
    res, n = seq.camera.resolution, len(seq)
    n_px = n * res.height * res.width
    rgb = np.ndarray((n, res.height, res.width, 3), np.uint8, buf)
    depth = np.ndarray((n, res.height, res.width), np.float32, buf, offset=3 * n_px)
    return rgb, depth


_RENDER_WORKER: dict = {}  # a render worker's own state, set by its initializer
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _render_worker_init(shm_names: dict) -> None:
    seqs = _render_sets()
    shms = {name: shared_memory.SharedMemory(name=shm) for name, shm in shm_names.items()}
    _RENDER_WORKER.update(seqs=seqs, shms=shms, arrays={
        name: _frame_arrays(shm.buf, seqs[name]) for name, shm in shms.items()})


def _render_frame(job: tuple) -> None:
    name, i = job
    rgb, depth = _RENDER_WORKER["arrays"][name]
    rgb[i], depth[i] = _RENDER_WORKER["seqs"][name].frame(i)


class HostRender:
    """The frames the later legs need, rendered on the host in the background
    while the earlier legs run: the mono leg's 520 KITTI-sized street frames
    (RGB, true depth) first, then the train leg's (the synthetic trainer's
    160 views, the street trainer's 390 at 256x80 and 130 at 1024x320).  A
    spawned pool (two cores left to the legs) writes them into one shared
    memory block per sequence, so nothing is pickled back."""

    def __init__(self):
        self.seqs = _render_sets()
        self.seq = self.seqs["mono"]
        self.jobs = {"mono": ["mono"], "train": [n for n in self.seqs if n.startswith("train_")]}
        self._shm = {}
        for name, seq in self.seqs.items():
            res = seq.camera.resolution
            self._shm[name] = shared_memory.SharedMemory(
                create=True, size=7 * len(seq) * res.height * res.width)
        self.workers = max(len(os.sched_getaffinity(0)) - 2, 1)
        self._t0 = time.perf_counter()
        # one BLAS thread per worker (read when a worker loads numpy): idle
        # OpenBLAS threads spin, and would take the cores the legs run on
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
        try:
            self._pool = multiprocessing.get_context("spawn").Pool(
                self.workers, initializer=_render_worker_init,
                initargs=({name: shm.name for name, shm in self._shm.items()},))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        # queued in this order: the mono leg's frames come first
        self._jobs = {job: self._pool.map_async(
            _render_frame, [(name, i) for name in names for i in range(len(self.seqs[name]))],
            chunksize=4) for job, names in self.jobs.items()}

    def host_frames(self, job: str) -> dict:
        """Wait for one job's frames ("mono" or "train"), copy them out of
        their shared blocks and free those: by sequence name, a list of
        (RGB, depth) numpy frames in host memory, as the JAX bench holds
        them.  The pool stops once every job is fetched."""
        t_wait = time.perf_counter()
        self._jobs.pop(job).get()
        done = time.perf_counter()
        if not self._jobs:
            self._pool.close()
            self._pool.join()
        out = {}
        for name in self.jobs[job]:
            views = _frame_arrays(self._shm[name].buf, self.seqs[name])
            rgb, depth = np.array(views[0]), np.array(views[1])
            del views  # the views must go before the block is closed
            self._release(name)
            out[name] = list(zip(rgb, depth))
        n = sum(len(f) for f in out.values())
        log(f"[render] {job}: {n} frames rendered on {self.workers} background host processes, "
            f"done {done - self._t0:.1f} s after the start (waited {done - t_wait:.1f} s for them)")
        return out

    def _release(self, name: str) -> None:
        shm = self._shm.pop(name, None)
        if shm is not None:
            shm.close()
            shm.unlink()

    def stop(self) -> None:
        """End the workers and free the blocks, whatever state they are in."""
        self._pool.terminate()
        self._pool.join()
        for name in list(self._shm):
            self._release(name)


def _range_device_ms(prof, prefix: str) -> dict:
    """Per `record_function` range named `prefix*`: (calls, device ms in
    all, host ms in all) from its host-side event (its device-timeline twin
    carries no host time)."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(prefix) and e.device_type == torch.autograd.DeviceType.CPU:
            dev = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            out[e.key] = (e.count, dev / 1e3, e.cpu_time_total / 1e3)
    return out


def phase_mono_street(seq: StreetSequence, frames: list) -> dict:
    """The monocular hybrid stack at 1024x320 through `Engine.process_frame`
    with RGB only, as the JAX bench's `_run_mono_street` drives it.
    `frames` are (RGB, depth) numpy pairs in host memory, so each frame pays
    its upload as in the bench.  Then K2 against its plain version on the
    lap's full map."""
    from torch.profiler import ProfilerActivity, profile

    camera = seq.camera
    rgbs = [rgb for rgb, _ in frames]
    cfg = EngineConfig(**MONO)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    eng.set_depth_predictor(DepthPredictor.pretrained_street())
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fe.sparse_tracker = SparseTracker(camera.intrinsics, **MONO_TRACKER)
    fe.sparse_tracker.pose = fe.pose
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only the main path's launches from here
    n_plain = STREET_WARMUP - STREET_PROFILED
    warm_walls = []
    for i in range(n_plain):
        t1 = time.perf_counter()
        eng.process_frame("cam0", rgbs[i], None, float(i), sync=False)
        torch.cuda.synchronize()
        warm_walls.append(1e3 * (time.perf_counter() - t1))
    warm_walls = np.array(warm_walls)
    log(f"[mono] warm-up frames 0-{n_plain - 1}, each synchronised: {warm_walls.sum() / 1e3:.1f} s; "
        f"median {np.median(warm_walls):.1f} ms, max {warm_walls.max():.1f} ms (frame "
        f"{int(warm_walls.argmax())}), frames 0-9 {warm_walls[:10].round(1).tolist()} ms")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_plain, STREET_WARMUP):
            eng.process_frame("cam0", rgbs[i], None, float(i), sync=False)
        torch.cuda.synchronize()
    prof_wall = 1e3 * (time.perf_counter() - t0) / STREET_PROFILED
    t0 = time.perf_counter()
    busy, ops = _device_us(prof)
    stages = _range_device_ms(prof, "frame.")
    top = _top_device_ops(prof)
    log(f"[mono] the profile of frames {n_plain}-{STREET_WARMUP - 1} read in "
        f"{time.perf_counter() - t0:.1f} s")
    walls, syncs, flushed = [], [], []
    sites: dict = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t_start = time.perf_counter()
            for i in range(STREET_WARMUP, MONO_FRAMES):
                n0, f0 = len(caught), len(fe.sparse_tracker._pending)
                t1 = time.perf_counter()
                eng.process_frame("cam0", rgbs[i], None, float(i), sync=False)
                walls.append(time.perf_counter() - t1)
                new = [w for w in caught[n0:] if "synchroniz" in str(w.message)]
                syncs.append(len(new))
                for w in new:
                    site = f"{os.path.relpath(w.filename)}:{w.lineno}"
                    sites[site] = sites.get(site, 0) + 1
                flushed.append(len(fe.sparse_tracker._pending) <= f0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t_start
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = counts()
    shapes = by_shape()
    fused_check("mono", launches)
    peak = torch.cuda.max_memory_allocated()
    n_timed = MONO_FRAMES - STREET_WARMUP
    stats = torch.stack(fe.stats_log).cpu().numpy()
    est = [p for _, p in fe.trajectory]
    gt = [seq.gt_pose(i) for i in range(len(est))]
    ate = ate_rmse(est, gt)
    last = MONO_FRAMES - 1
    final_err = float(np.linalg.norm(fe.pose[:3, 3] - seq.gt_pose(last)[:3, 3]))
    surfels = eng.surfel_count("cam0")
    trk = fe.sparse_tracker
    syncs, flushed = np.array(syncs, float), np.array(flushed)
    walls = 1e3 * np.array(walls)
    log(f"[mono] {n_timed} timed frames ({STREET_WARMUP}-{last}) in {dt:.3f} s: {n_timed / dt:.3f} fps, "
        f"{1e3 * dt / n_timed:.2f} ms/frame; frame wall median {np.median(walls):.2f} ms, "
        f"max {walls.max():.2f} ms")
    log(f"[mono] ATE {ate:.4f} m against gt_pose(i); final live pose {final_err:.3f} m from "
        f"gt_pose({last}); sparse loops closed {trk.loops_closed}, hybrid loops closed "
        f"{fe.loops_closed}, local BA runs {trk.local_ba_runs}, sparse keyframes "
        f"{len(trk.keyframes)}; surfels {surfels}; peak device memory {peak / 2**20:.1f} MiB")
    log(f"[mono] host syncs: {syncs.mean():.3f}/frame over the timed frames ({syncs.sum():.0f} in "
        f"all); {syncs[~flushed].mean() if (~flushed).any() else float('nan'):.3f} on frames "
        f"without a tracker flush, {syncs[flushed].mean() if flushed.any() else float('nan'):.3f} "
        f"on the {int(flushed.sum())} flush frames; max {syncs.max():.0f} on one frame")
    for site, n in sorted(sites.items(), key=lambda kv: -kv[1]):
        log(f"[mono] sync site {site}: {n} ({n / n_timed:.3f}/frame)")
    log(f"[mono] frames {n_plain}-{STREET_WARMUP - 1} under the profiler: {prof_wall:.2f} ms/frame "
        f"wall, device busy {busy / 1e3 / STREET_PROFILED:.3f} ms/frame, "
        f"{ops / STREET_PROFILED:.0f} device ops/frame, device idle "
        f"{100 * (1 - busy / 1e3 / prof_wall):.1f}% of the wall")
    for key, (calls, dev_ms, host_ms) in sorted(stages.items()):
        log(f"[mono] {key:20s} {calls:3d} calls, device {dev_ms / STREET_PROFILED:8.3f} ms/frame, "
            f"host wall {host_ms / STREET_PROFILED:8.2f} ms/frame")
    for name, (n, us) in top:
        log(f"[mono] device op {name[:90]}: {n / STREET_PROFILED:.1f}/frame, "
            f"{us / 1e3 / STREET_PROFILED:.3f} ms/frame")
    log(f"[mono] launches over the {MONO_FRAMES} frames: gram {launches['gram']} "
        f"({launches['gram'] / MONO_FRAMES:.2f}/frame), deform {launches['deform']}; "
        f"gram by (P, C): {shapes}")
    log(f"[mono] hybrid loops closed in the first {MONO_FRAMES} frames: {fe.loops_closed} (the "
        f"lap's loop comes at its end)")
    if not np.isfinite(stats[:, stepmod.STAT_POSE0:]).all() or not np.isfinite(np.stack(est)).all():
        raise AssertionError("non-finite poses on the mono street lap")
    if not surfels > 100_000:
        raise AssertionError(f"only {surfels} surfels on the mono street lap")
    if launches["gram"] == 0:
        raise AssertionError("the mono street leg launched no gram kernel")
    # K2 on the lap's full map with a graph sampled as a hybrid closure on
    # this configuration samples it, its node transforms drawn from a seed
    data, count = fe.state.map_data, fe.state.map_count
    graph = dg.sample_graph(data, count, cfg.max_deform_nodes, cfg.deform_graph_sample_rate)
    gen = np.random.default_rng(2)
    K = graph.pos.shape[0]
    A = np.eye(3, dtype=np.float32)[None] + 0.02 * gen.normal(size=(K, 3, 3)).astype(np.float32)
    t = 0.1 * gen.normal(size=(K, 3)).astype(np.float32)
    graph = graph._replace(A=torch.from_numpy(A).cuda(), t=torch.from_numpy(t).cuda())
    k2 = _deform_checks(f"mono lap map, {int(graph.valid.sum())}-node sampled graph",
                        data, count, graph)
    return dict(launches=launches, shapes=shapes, fps=n_timed / dt, ate=ate,
                loops_sparse=trk.loops_closed, loops_hybrid=fe.loops_closed, k2=k2)


def phase_street_sparse(seq: StreetSequence, frames: list) -> None:
    """`tests/test_street.py`'s full-lap sparse loop closure on the card, on
    the mono leg's host frames and their true depth, uploaded per frame."""
    trk = SparseTracker(seq.camera.intrinsics, **MONO_TRACKER)
    trk.pose = seq.gt_pose(0).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rgb, depth in frames:
        rgb, depth = torch.as_tensor(rgb, device="cuda"), torch.as_tensor(depth, device="cuda")
        trk.track(preprocess.rgb_to_intensity(rgb), depth)
    trk.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = float(np.linalg.norm(trk.pose[:3, 3] - seq.gt_pose(STREET_FRAMES - 1)[:3, 3]))
    log(f"[street sparse] {STREET_FRAMES} frames in {dt:.2f} s ({STREET_FRAMES / dt:.2f} fps): "
        f"loops closed {trk.loops_closed}, local BA runs "
        f"{trk.local_ba_runs}, keyframes {len(trk.keyframes)}, final error {err:.4f} m")
    if trk.loops_closed < 1:
        raise AssertionError("the street sparse lap closed no loop")
    if not err < 0.5:
        raise AssertionError(f"street sparse lap final error {err:.3f} m >= 0.5 m")


def phase_hybrid_closure() -> dict:
    """`tests/test_hybrid.py`'s hybrid closure at 640x480: ground-truth
    frames, the same views 100 ticks later with an 8 cm drift, then
    `apply_hybrid_loop` with the correction that undoes it."""
    camera = _camera()
    seq = SyntheticSequence(camera=camera, num_frames=40, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(**HYBRID)
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(10):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    eng.global_tick = 100  # epoch 1 becomes inactive
    for i in range(10):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += HYBRID_DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
    pre_data, count = fe.state.map_data.clone(), fe.state.map_count.clone()
    n = int(count)
    C = np.eye(4, dtype=np.float32)
    C[:3, 3] = -HYBRID_DRIFT
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, info, graph = loopsmod.apply_hybrid_loop(fe.state, C, camera, cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = counts()["deform"]
    pre, post = pre_data[:n].cpu().numpy(), state.map_data[:n].cpu().numpy()
    t_init = pre[:, sm.INIT_TIME]
    moved = post[:, sm.POS] - pre[:, sm.POS]
    recent, old = t_init >= 100, t_init < 50
    mean_corr = moved[recent].mean(axis=0)
    old_max = float(np.abs(moved[old]).max())
    log(f"[hybrid] 640x480, {n} surfels ({int(recent.sum())} recent, {int(old.sum())} old): "
        f"closed {info.closed}, constraint error {info.cons_error:.3e} m, mean correction of "
        f"the recent surfels {mean_corr} (want {-HYBRID_DRIFT} within "
        f"{0.35 * np.linalg.norm(HYBRID_DRIFT):.3f}), old surfels moved at most {old_max:.4f} m, "
        f"{ms:.1f} ms, deform launches {launches}")
    if not info.closed:
        raise AssertionError(f"hybrid closure not accepted: {info}")
    if not np.all(np.abs(mean_corr + HYBRID_DRIFT) <= 0.35 * np.linalg.norm(HYBRID_DRIFT)):
        raise AssertionError(f"hybrid closure mean correction {mean_corr}")
    if not old_max < 0.03:
        raise AssertionError(f"hybrid closure moved old surfels by {old_max:.4f} m")
    if launches < 1:
        raise AssertionError("the hybrid closure launched no deform kernel")
    # K2 against its plain version at this launch: the map before the
    # closure and the graph the closure applied
    k2 = _deform_checks(f"hybrid closure map, its {int(graph.valid.sum())}-node graph",
                        pre_data, count, graph)
    return dict(launches=launches, k2=k2)


# ---------------------------------------------------------------------------
# multi-camera: two frontends in one process, then a collaborative session
# of two ranks on the one card
# ---------------------------------------------------------------------------

# tests/test_intermap.py:31-39's configuration, the map scaled 8x with the
# 16x pixels of 640x480 to the other legs' 1<<20 rows per camera
MULTI = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=False, loop_check_interval=4, time_delta=500, confidence_threshold=1.0,
)
MULTI_OFFSET, MULTI_TRACKED = 6, 16
# tests/test_intermap_collab.py's session (:31-39) and full pipeline
# (:218-226), the maps scaled 16x with the pixels to 1<<20 rows.  The full
# pipeline's lap jumps 10 orbit frames back; at 160x120 the test's 3
# pyramid levels end at 40x30, and at 640x480 the same coarsest size takes 5
# (with 3 or 4 levels neither camera closes a loop after the jump), with
# the bench's row stride 2 at this resolution
COLLAB_STEP = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=200, max_depth=8.0,
)
COLLAB_LOOP = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, max_depth=8.0, nid_keyframing=True,
    nid_threshold=0.85, open_loop=False, time_delta=30, deform_graph_sample_rate=2000,
    max_deform_nodes=256, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
    pyramid_levels=5, track_row_stride=2,
)
COLLAB_LAP, COLLAB_TOTAL, COLLAB_OFF = 30, 52, 6
IM_SOLO, IM_ROUNDS, IM_ROUND = 16, 14, dict(verify_scale=2, fern_factor=4)
COLLAB_TIMEOUT_S = 900
CONSUME_ATOL = 1e-5  # tests/test_torch_intermap.py's tolerance on map rows


def _offset() -> np.ndarray:
    """camB's private world frame differs from camA's by this transform
    (`tests/test_intermap.py`)."""
    T = np.eye(4, dtype=np.float32)
    c, s_ = np.cos(0.4), np.sin(0.4)
    T[:3, :3] = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [1.0, 0.3, -0.5]
    return T


def _rot_err(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def _surface_distance(seq: SyntheticSequence, p: np.ndarray) -> np.ndarray:
    """Each point's distance to the analytic scene (walls and spheres)."""
    lo, hi = seq.scene.lo, seq.scene.hi
    on_wall = np.min(np.minimum(np.abs(p - lo), np.abs(p - hi)), axis=1)
    on_sphere = np.min(np.abs(
        np.linalg.norm(p[:, None, :] - seq.scene.sphere_c[None], axis=-1) - seq.scene.sphere_r[None]
    ), axis=1)
    return np.minimum(on_wall, on_sphere)


def phase_two_cameras() -> dict:
    """`tests/test_intermap.py`'s two cameras in one engine (camB in its own
    frame, 6 orbit frames ahead, poses injected) until their maps merge,
    each loop-check frame under `torch.profiler` so that the merge's
    `merge.*` ranges are timed; then both track densely into the one map
    for 16 more frames each; then `tests/test_engine.py`'s batch align."""
    from torch.profiler import ProfilerActivity, profile

    camera = _camera()
    seq = SyntheticSequence(camera=camera, num_frames=40, radius=0.35, max_angle=0.3)
    # host frames, as the bench feeds them (each uploaded by process_frame),
    # rendered before they are needed so that no timing includes a render
    frames = {i: seq.frame(i) for i in range(MULTI_OFFSET + 14 + MULTI_TRACKED + 1)}
    cfg = EngineConfig(**MULTI)
    eng = Engine(camera, cfg)
    eng.frontend("camA")
    eng.frontend("camB")
    off = _offset()
    eng.frontends["camA"].pose = seq.gt_pose(0).astype(np.float32)
    eng.frontends["camB"].pose = (off @ seq.gt_pose(MULTI_OFFSET)).astype(np.float32)
    merge_walls = []
    merge_into = eng.merge_into

    def timed_merge(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge_into(*a)
        torch.cuda.synchronize()
        merge_walls.append(1e3 * (time.perf_counter() - t0))

    eng.merge_into = timed_merge
    reset_counts()  # count only this path's launches from here
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    merged_at, prof = None, None
    last = {"camA": 0, "camB": MULTI_OFFSET}
    for k in range(14):
        for name, i, pose in (("camA", k, seq.gt_pose(k)),
                              ("camB", MULTI_OFFSET + k, off @ seq.gt_pose(MULTI_OFFSET + k))):
            fe = eng.frontends[name]
            frame = frames[i]
            if (fe.tick + 1) % cfg.loop_check_interval == 0:
                with profile(activities=activities) as p_:
                    eng.process_frame(name, *frame, float(i), in_pose=pose.astype(np.float32))
                    torch.cuda.synchronize()
                prof = p_
            else:
                eng.process_frame(name, *frame, float(i), in_pose=pose.astype(np.float32))
            last[name] = i
            if len(eng.maps) == 1:
                merged_at = (name, k)
                break
        if merged_at:
            break
    if merged_at is None:
        raise AssertionError("the two cameras' maps never merged")
    feA, feB = eng.frontends["camA"], eng.frontends["camB"]
    be = eng.maps[feA.map_name]
    d = np.linalg.inv(np.linalg.inv(feA.pose) @ feB.pose) @ (
        np.linalg.inv(seq.gt_pose(last["camA"])) @ seq.gt_pose(last["camB"])
    )
    terr, rerr = float(np.linalg.norm(d[:3, 3])), _rot_err(d[:3, :3])
    p = sm.snapshot(eng.map_of(be.name)).positions
    if np.linalg.norm(feA.pose[:3, 3] - seq.gt_pose(last["camA"])[:3, 3]) >= 0.1:
        inv = np.linalg.inv(off)  # the merged map lives in camB's frame
        p = (inv[:3, :3] @ p.T).T + inv[:3, 3]
    med = float(np.median(_surface_distance(seq, p)))
    ranges = _range_device_ms(prof, "merge.")
    log(f"[two cameras] merged at camera {merged_at[0]}'s frame {last[merged_at[0]]} (step "
        f"{merged_at[1]}): relative pose error {terr * 1e3:.3f} mm, {rerr:.5f} rad (bounds 50 mm, "
        f"0.05 rad); merged map {eng.surfel_count(be.name)} surfels, median distance to the scene "
        f"{med * 1e3:.4f} mm (bound 20 mm); surfels dropped {be.dropped}")
    log(f"[two cameras] merge_into {merge_walls[0]:.2f} ms (synchronised host wall, under the "
        f"profiler)")
    for key, (calls, dev_ms, host_ms) in sorted(ranges.items()):
        log(f"[two cameras] {key:16s} {calls} call(s), host {host_ms:8.2f} ms, device {dev_ms:8.3f} ms")
    if not (terr < 0.05 and rerr < 0.05):
        raise AssertionError(f"merge relative pose error {terr:.4f} m, {rerr:.4f} rad")
    if not med < 0.02:
        raise AssertionError(f"merged map median surface distance {med:.4f} m")
    # both cameras track densely into the one map, no pose injection
    ia, ib = last["camA"] + 1, last["camB"] + 1
    n0 = {name: len(fe.ts_log) for name, fe in eng.frontends.items()}
    torch.cuda.synchronize()

    def track():
        t0 = time.perf_counter()
        for j in range(MULTI_TRACKED):
            eng.process_frame("camA", *frames[ia + j], float(ia + j), sync=False)
            eng.process_frame("camB", *frames[ib + j], float(ib + j), sync=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dt, syncs = _count_syncs(track)
    ates = {}
    for name, first in (("camA", ia), ("camB", ib)):
        est = [q for _, q in eng.frontends[name].trajectory[n0[name]:]]
        ates[name] = ate_rmse(est, [seq.gt_pose(first + j) for j in range(MULTI_TRACKED)])
    n_cf = 2 * MULTI_TRACKED
    log(f"[two cameras] then {MULTI_TRACKED} frames each, tracked into the one map: "
        f"{1e3 * dt / n_cf:.2f} ms per camera-frame ({n_cf / dt:.2f} camera-frames/s), host syncs "
        f"{syncs / n_cf:.2f} per camera-frame; ATE camA {ates['camA'] * 1e3:.3f} mm, camB "
        f"{ates['camB'] * 1e3:.3f} mm; map {eng.surfel_count(be.name)} surfels")
    if not all(np.isfinite(fe.pose).all() for fe in eng.frontends.values()):
        raise AssertionError("non-finite poses after the merge")
    # where a camera-frame's time goes: 2 more frames each, profiled
    n_p = 2
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(MULTI_TRACKED, MULTI_TRACKED + n_p):
            eng.process_frame("camA", *frames[ia + j], float(ia + j), sync=False)
            eng.process_frame("camB", *frames[ib + j], float(ib + j), sync=False)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (2 * n_p)
    busy, ops = _device_us(prof)
    log(f"[two cameras] {2 * n_p} camera-frames under the profiler: {wall:.2f} ms wall, device "
        f"busy {busy / 1e3 / (2 * n_p):.3f} ms, {ops / (2 * n_p):.0f} device ops per camera-frame")
    for key, (calls, dev_ms, host_ms) in sorted(_range_device_ms(prof, "frame.").items()):
        log(f"[two cameras] {key:18s} {calls} calls, device {dev_ms / (2 * n_p):.3f} ms, host "
            f"{host_ms / (2 * n_p):.2f} ms per camera-frame")
    for name, (n, us) in _top_device_ops(prof, 5):
        log(f"[two cameras] device op {name[:80]}: {n / (2 * n_p):.1f}/camera-frame, "
            f"{us / 1e3 / (2 * n_p):.3f} ms/camera-frame")
    # tests/test_engine.py's batch align, at this resolution
    eng2 = Engine(camera, EngineConfig(max_surfels=MULTI["max_surfels"], depth_cutoff=8.0,
                                       depth_factor=1.0))
    eng2.frontend("camA")
    eng2.frontend("camB")
    for i in range(3):
        eng2.process_frame("camA", *frames[i], float(i))
    for i in range(3, 6):
        eng2.process_frame("camB", *frames[i], float(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng2.batch_align("camA", "camB", merge=True)
    torch.cuda.synchronize()
    ba_ms = 1e3 * (time.perf_counter() - t0)
    if out is None:
        raise AssertionError("batch align rejected a genuine overlap")
    T_ab, inl, rms = out
    T_true = np.linalg.inv(seq.gt_pose(3)) @ seq.gt_pose(0)
    bterr = float(np.linalg.norm(T_ab[:3, 3] - T_true[:3, 3]))
    log(f"[batch align] inliers {inl} (gate >= 30), rms {rms:.4f} (gate < 0.25), translation "
        f"error {bterr * 1e3:.2f} mm (bound 200 mm), {ba_ms:.1f} ms with the merge; maps "
        f"{len(eng2.maps)}")
    if not (inl >= 30 and rms < 0.25 and bterr < 0.2 and len(eng2.maps) == 1):
        raise AssertionError(f"batch align: inliers {inl}, rms {rms}, error {bterr}")
    launches, shapes = counts(), by_shape()
    fused_check("two cameras", launches)
    log(f"[two cameras] launches with the batch align: gram {launches['gram']}, deform "
        f"{launches['deform']}; gram by (P, C): {shapes}")
    return dict(launches=launches, shapes=shapes)


def _noisy_pose_graph(K: int = 16, noise: float = 0.03, seed: int = 0):
    """`tests/test_ba.py`'s ring of 16 keyframes: exact odometry edges, an
    exact loop edge, and a drifted initial estimate."""
    from densemonoslam_tpu_torch.utils import se3

    rng = np.random.default_rng(seed)
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = [np.sin(a), 0.1 * np.sin(2 * a), np.cos(a) - 1]
        gt.append(T)
    Z = [np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(K - 1)] + [np.linalg.inv(gt[-1]) @ gt[0]]
    ei, ej = list(range(K)), list(range(1, K)) + [0]
    est = [gt[0]]
    for k in range(K - 1):
        xi = torch.from_numpy(rng.normal(0, noise, 6).astype(np.float32))
        est.append(est[-1] @ Z[k] @ se3.se3_exp(xi).numpy())
    return (np.stack(gt), np.stack(est).astype(np.float32), np.array(ei), np.array(ej),
            np.stack(Z).astype(np.float32), np.ones(K, np.float32))


def _ba_problem_ring(K: int = 6, Pn: int = 64, seed: int = 0):
    """`tests/test_ba.py`'s BA problem: 6 cameras on a ring, 64 points, the
    first two poses at the truth."""
    from densemonoslam_tpu_torch.utils import se3

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 100.0, 100.0, 63.5, 47.5
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = [0.4 * np.sin(a), 0.1 * np.sin(2 * a), 0.4 * (np.cos(a) - 1)]
        gt.append(T)
    pts = rng.uniform(-1.0, 1.0, (Pn, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cam, pnt, uv = [], [], []
    for c in range(K):
        Tinv = np.linalg.inv(gt[c])
        for q in range(Pn):
            X = Tinv[:3, :3] @ pts[q] + Tinv[:3, 3]
            u, v = X[0] / X[2] * fx + cx, X[1] / X[2] * fy + cy
            if X[2] >= 0.2 and 0 <= u < 128 and 0 <= v < 96:
                cam.append(c)
                pnt.append(q)
                uv.append([u, v])
    poses = []
    for c in range(K):
        xi = rng.normal(0, 0.02, 6).astype(np.float32) * (c > 1)
        poses.append(gt[c] @ se3.se3_exp(torch.from_numpy(xi)).numpy())
    points = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    return CameraIntrinsics(fx, fy, cx, cy), dict(
        poses=np.stack(poses).astype(np.float32), points=points.astype(np.float32),
        cam_idx=np.array(cam, np.int64), pnt_idx=np.array(pnt, np.int64),
        uv=np.array(uv, np.float32), valid=np.ones(len(cam), bool), z=np.zeros(len(cam), np.float32),
    ), np.stack(gt)


def _widened(state, rows: int):
    """`state` with its map copied into a map of `rows` more rows (the
    added rows empty, the dump slot last)."""
    data = state.map_data
    return state.replace(map_data=torch.cat([data[:-1], data.new_zeros((rows + 1, data.shape[1]))]))


def collab_rank(leg: str) -> dict:
    """One rank of the collaborative session, in a process of its own,
    joined through `multihost.initialize()` from the environment.  `leg`
    "solo" times the session's collab steps alone (world 1); "session" also
    runs, on 2 ranks, `tests/test_intermap_collab.py`'s inter-map session
    until a merge (and the merge round again with `consume=True` on the
    same inputs, the maps widened to twice their rows so that the target
    has room for every live row of the source), its full pipeline (collab
    steps + local-loop rounds), distributed PGO and BA against the
    single-device solves, and the sharded K2 apply over a (cam 1 x map 2)
    mesh against one rank's K2.  Returns what the parent checks and sums."""
    import copy

    from densemonoslam_tpu_torch.parallel import ba as pba
    from densemonoslam_tpu_torch.parallel import collab, intermap, map_shard, multihost
    from densemonoslam_tpu_torch.parallel import mesh as meshmod

    if not multihost.initialize():
        raise RuntimeError("the rank found no session in its environment")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    camera = _camera()
    W, H = camera.resolution.width, camera.resolution.height
    intr = camera.intrinsics
    res: dict = dict(rank=rank)

    def rlog(msg: str) -> None:
        log(f"[rank {rank}] {msg}")

    seq = SyntheticSequence(camera=camera, num_frames=40, radius=0.3, max_angle=0.25)
    frames = {i: seq.frame(i) for i in range(40)}
    # ---- the session's collab steps, timed (the solo leg is this alone) ----
    cfg = EngineConfig(**COLLAB_STEP)
    reset_counts()
    sess = multihost.MultiHostSession(intr, H, W, cfg)
    off = rank * COLLAB_OFF
    warm = 4
    for i in range(warm):
        sess.step(frames[i + off][0][None], frames[i + off][1][None])
    torch.cuda.synchronize()
    c0 = dict(meshmod.COUNTS)
    t0 = time.perf_counter()
    for i in range(warm, IM_SOLO):
        sess.step(frames[i + off][0][None], frames[i + off][1][None])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_steps = IM_SOLO - warm
    per_step = {k: (v - c0.get(k, 0)) / n_steps for k, v in meshmod.COUNTS.items()}
    res["fps"] = world * n_steps / dt  # camera-frames per second over the ranks
    res["per_step"] = per_step
    rlog(f"{n_steps} timed collab steps in {dt:.3f} s: {1e3 * dt / n_steps:.2f} ms per step, "
         f"{res['fps']:.2f} camera-frames/s over {world} rank(s); per step: {per_step}")
    # where a collab step's time goes, the collectives split out
    from torch.profiler import ProfilerActivity, profile

    n_p = 4
    saved = copy.deepcopy(sess.state)  # the profiled steps leave the session as it was
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(IM_SOLO, IM_SOLO + n_p):
            sess.step(frames[i + off][0][None], frames[i + off][1][None])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t1) / n_p
    sess.state, sess.ticks = saved, sess.ticks - n_p
    busy, ops = _device_us(prof)
    coll = _range_device_ms(prof, "collective.")
    res["profile"] = dict(wall_ms=wall, busy_ms=busy / 1e3 / n_p, ops=ops / n_p, collective_host_ms={
        k: host / n_p for k, (_, _, host) in coll.items()})
    rlog(f"{n_p} collab steps under the profiler: {res['profile']}")
    if leg == "solo":
        res["launches"] = counts()
        res["shapes"] = {f"{p}x{c}": n for (p, c), n in by_shape().items()}
        return res

    # ---- inter-map rounds until a merge, then consume on the same inputs ----
    sess.enable_intermap(**IM_ROUND)
    consume = intermap.make_intermap_round(sess.mesh, intr, H, W, cfg, consume=True, **IM_ROUND)
    info, round_ms = None, []
    for i in range(IM_SOLO, IM_SOLO + IM_ROUNDS):
        rgb, dep = frames[i + off]
        sess.step(rgb[None], dep[None])
        pre = (copy.deepcopy(sess.state), copy.deepcopy(sess._im_state))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = sess.intermap_round(rgb[None], dep[None])
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t1))
        if info.merged:
            break
    res["merge"] = {k: np.asarray(v).tolist() for k, v in info._asdict().items()}
    res["merge_frame"] = i
    res["pose_after"] = sess.state.pose.cpu().numpy().tolist()
    rlog(f"inter-map: {len(round_ms)} rounds, {np.mean(round_ms):.1f} ms per round; merged "
         f"{bool(info.merged)} at frame {i}: requester {int(info.requester)}, target "
         f"{int(info.target)}, map ids {info.map_ids.tolist()}")
    c1 = dict(meshmod.COUNTS)
    rgb_d, dep_d = torch.as_tensor(rgb, device="cuda"), torch.as_tensor(dep, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, ist, cinfo = consume(_widened(pre[0], cfg.max_surfels), pre[1], rgb_d, dep_d)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    req, before, after = int(cinfo.requester), int(pre[0].map_count), int(state.map_count)
    # the rows the target appended must be the source's live rows moved by
    # T: the source's rows as they were come over once more (not counted)
    src = pre[0].map_data[:-1].clone()
    torch.distributed.broadcast(src, req)
    live = src[src[:, sm.CONF] > 0].double()
    T = cinfo.T[req].double()
    want = live.clone()
    want[:, sm.POS] = live[:, sm.POS] @ T[:3, :3].T + T[:3, 3]
    want[:, sm.NORMAL] = live[:, sm.NORMAL] @ T[:3, :3].T
    got = state.map_data[before:after].double()
    res["consume"] = dict(
        merged=bool(cinfo.merged), requester=req, target=int(cinfo.target),
        T=cinfo.T.cpu().numpy().tolist(), dropped=int(cinfo.dropped), count_before=before,
        count_after=after, live_before=int((pre[0].map_data[:-1, sm.CONF] > 0).sum()),
        ferns_after=int(ist.count), ms=ms,
        rows_err=float((got - want).abs().max()) if got.shape == want.shape else float("inf"),
        bytes={k: v - c1.get(k, 0) for k, v in meshmod.COUNTS.items() if "bytes" in k},
    )
    rlog(f"consume round on the merge round's inputs: {res['consume']}")
    del sess, pre, state, ist, src, live, want, got

    # ---- tests/test_intermap_collab.py's full pipeline ----------------------
    lcfg = EngineConfig(**COLLAB_LOOP)
    mesh = meshmod.make_mesh()
    step = collab.make_collab_step(mesh, intr, H, W, lcfg)
    loop_round = collab.make_collab_local_loop(mesh, intr, H, W, lcfg)
    state = collab.init_state(lcfg.max_surfels, H, W)
    bank = collab.init_rel_banks()
    closed = np.zeros(world, np.int64)
    t1 = time.perf_counter()
    for i in range(COLLAB_TOTAL):
        rgb, dep = frames[(i + off) % COLLAB_LAP]
        state, stats, total = step(state, rgb, dep)
        if i >= COLLAB_LAP and i % 4 == 0:
            state, bank, infos = loop_round(state, bank)
            infos = infos.cpu().numpy()
            closed += (infos[:, 0] > 0).astype(np.int64)
            rlog(f"local-loop round at frame {i}: (closed, inactive, inliers, icp error, "
                 f"constraint error) per camera {infos.round(6).tolist()}")
    torch.cuda.synchronize()
    res["loops_closed"] = closed.tolist()
    res["pipeline_s"] = time.perf_counter() - t1
    res["map_count"] = int(state.map_count)
    rlog(f"full pipeline: {COLLAB_TOTAL} frames with local-loop rounds in {res['pipeline_s']:.2f} s; "
         f"loops closed per camera {closed.tolist()}; map {int(state.map_count)} surfels, "
         f"session total {int(total)}")
    del state
    res["launches"] = counts()

    # ---- distributed PGO and BA against the single-device solves ------------
    gt, est, ei, ej, Z, w = _noisy_pose_graph()
    pad = (-len(ei)) % mesh.n_cams
    T_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    edges = pba.PoseGraphEdges(
        T_(np.concatenate([ei, np.zeros(pad, np.int64)])), T_(np.concatenate([ej, np.zeros(pad, np.int64)])),
        T_(np.concatenate([Z, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])),
        T_(np.concatenate([w, np.zeros(pad, np.float32)])),
    )
    dist_p, _ = pba.make_distributed_pgo(mesh)(T_(est), edges)
    single_p, _ = pba.optimise_pose_graph(T_(est), edges)

    def pose_err(p):
        return float(np.mean(np.linalg.norm(p.cpu().numpy()[:, :3, 3] - gt[:, :3, 3], axis=1)))

    res["pgo"] = dict(dist=pose_err(dist_p), single=pose_err(single_p), before=pose_err(T_(est)),
                      max_diff=float((dist_p - single_p).abs().max()))
    bintr, prob, _ = _ba_problem_ring()
    lay = pba.shard_ba_problem(pba.BAProblem(**prob), mesh.n_cams)
    dist_b, _, err_d = pba.make_distributed_ba(mesh, bintr, iters=4, fix_cameras=2)(
        T_(prob["poses"]), *map(T_, lay))
    single_b, err_s = pba.bundle_adjust(pba.BAProblem(**{k: T_(v) for k, v in prob.items()}),
                                        bintr, iters=4, fix_cameras=2)
    res["ba"] = dict(max_diff=float((dist_b - single_b.poses).abs().max()),
                     err_dist=float(err_d), err_single=float(err_s))
    rlog(f"distributed PGO {res['pgo']}; distributed BA {res['ba']}")

    # ---- the sharded K2 apply over a (cam 1 x map 2) mesh ---------------------
    mesh12 = meshmod.make_mesh(n_cams=1, n_map=world)
    data, count, graph = _synthetic_deform_case()
    k2 = counts()["deform"]
    out = map_shard.make_sharded_apply_to_map(mesh12)(data.clone(), count, graph)
    torch.cuda.synchronize()
    res["launches"]["deform"] += counts()["deform"] - k2
    one = deform.deform_map(data.clone(), count, graph)  # the comparison: not counted
    torch.cuda.synchronize()
    res["shard_equal"] = bool(torch.equal(out, one))
    res["shard_moved"] = float((out[:, sm.POS] - data[:, sm.POS]).abs().max())
    rlog(f"sharded K2 apply over map ranks: bit-identical to one rank's K2 {res['shard_equal']} "
         f"(largest move {res['shard_moved']:.4f} m)")
    res["shapes"] = {f"{p}x{c}": n for (p, c), n in by_shape().items()}
    return res


def _spawn_ranks(world: int, leg: str) -> list:
    """Run `collab_rank(leg)` on `world` ranks over gloo, each in its own
    process on this card with its output in a file (a rank that fills a
    pipe nobody reads would stall its peers at a collective); echo their
    logs; return their results."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "DMS_COORDINATOR": f"127.0.0.1:{port}", "DMS_NUM_HOSTS": str(world),
           "DMS_BACKEND": "gloo"}
    outs, failed = [], []
    with tempfile.TemporaryDirectory(prefix="collab-ranks-") as tmp:
        paths = [(os.path.join(tmp, f"rank{r}.out"), os.path.join(tmp, f"rank{r}.err"))
                 for r in range(world)]
        procs = []
        try:
            for r, (po, pe) in enumerate(paths):
                with open(po, "w") as fo, open(pe, "w") as fe:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), "--collab-rank", leg],
                        env={**env, "DMS_HOST_ID": str(r)}, stdout=fo, stderr=fe,
                    ))
            deadline = time.monotonic() + COLLAB_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, (po, pe)) in enumerate(zip(procs, paths)):
            with open(po) as fo, open(pe) as fe:
                out, err = fo.read(), fe.read()
            for line in out.splitlines():
                if not line.startswith("RESULT "):
                    log(line)
            results = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not results:
                failed.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
            else:
                outs.append(json.loads(results[-1][7:]))
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def phase_collab() -> dict:
    """The collaborative session: 1 rank alone, then 2 ranks on the card
    (see `collab_rank`)."""
    solo = _spawn_ranks(1, "solo")[0]
    ranks = _spawn_ranks(2, "session")
    return check_collab(solo, ranks)


def check_collab(solo: dict, ranks: list) -> dict:
    """Every check of the collaborative session, on what its ranks report."""
    seq = SyntheticSequence(camera=_camera(), num_frames=40, radius=0.3, max_angle=0.25)
    m0, m1 = ranks[0]["merge"], ranks[1]["merge"]
    if m0 != m1:
        raise AssertionError(f"the ranks disagree on the merge: {m0} != {m1}")
    if not m0["merged"]:
        raise AssertionError(f"the inter-map rounds never merged the maps: {m0}")
    req, tgt = m0["requester"], m0["target"]
    starts = {0: seq.gt_pose(0), 1: seq.gt_pose(COLLAB_OFF)}
    T_true = np.linalg.inv(starts[tgt]) @ starts[req]
    T = np.array(m0["T"][req])
    terr, rerr = float(np.linalg.norm(T[:3, 3] - T_true[:3, 3])), _rot_err(T[:3, :3] @ T_true[:3, :3].T)
    last = ranks[0]["merge_frame"]
    pose_errs = [
        float(np.linalg.norm(np.array(r["pose_after"])[:3, 3] - (
            np.linalg.inv(starts[tgt]) @ seq.gt_pose(last + c * COLLAB_OFF))[:3, 3]))
        for c, r in enumerate(ranks)
    ]
    log(f"[collab] both ranks report the same MergeInfo: requester {req}, target {tgt}, map ids "
        f"{m0['map_ids']}; T against the truth {terr * 1e3:.2f} mm, {rerr:.4f} rad (bounds 120 mm, "
        f"0.1 rad); poses in the merged frame {[round(e * 1e3, 2) for e in pose_errs]} mm (bound 200)")
    c0, c1 = ranks[0]["consume"], ranks[1]["consume"]
    live, ct = ranks[req]["consume"]["live_before"], ranks[tgt]["consume"]
    same = ("merged", "requester", "target", "T", "dropped")
    log(f"[collab] consume (maps widened to {2 * COLLAB_STEP['max_surfels']} rows): target "
        f"{c0['target']}, its map {ct['count_before']} -> {ct['count_after']} rows "
        f"({ct['count_after'] - ct['count_before']} moved of the source's {live} live rows, largest "
        f"difference from the source's rows moved by T {ct['rows_err']:.3g}, bound {CONSUME_ATOL}); "
        f"source emptied to {ranks[req]['consume']['count_after']}, dropped {c0['dropped']}; "
        f"{ct['ms']:.1f} ms, {ct['bytes']}")
    loops = ranks[0]["loops_closed"]
    log(f"[collab] full pipeline: loops closed per camera {loops} (ranks agree: "
        f"{ranks[0]['loops_closed'] == ranks[1]['loops_closed']})")
    log(f"[collab] distributed PGO (rank 0): {ranks[0]['pgo']}; BA: {ranks[0]['ba']}")
    log(f"[collab] sharded K2 apply bit-identical to one rank's K2: "
        f"{[r['shard_equal'] for r in ranks]}")
    log(f"[collab] camera-frames/s on the one card: 1 rank {solo['fps']:.2f}, 2 ranks "
        f"{ranks[0]['fps']:.2f} (two ranks share one card: this is not scaling); per collab step "
        f"on 2 ranks: {ranks[0]['per_step']}")
    checks = [
        (terr < 0.12 and rerr < 0.1, f"merge transform {terr:.4f} m, {rerr:.4f} rad"),
        (max(pose_errs) < 0.2, f"poses after the merge {pose_errs}"),
        (all(c0[k] == c1[k] for k in same), "the ranks disagree on the consume round"),
        (c0["merged"] and c0["T"] == m0["T"], "the consume round did not make the same merge"),
        (ranks[req]["consume"]["count_after"] == 0 and ranks[req]["consume"]["ferns_after"] == 0,
         "consume left the source's map or ferns"),
        (live > 0 and ct["count_after"] == ct["count_before"] + live and c0["dropped"] == 0,
         "consume's counts"),
        (ct["rows_err"] < CONSUME_ATOL, f"consume's appended rows differ by {ct['rows_err']}"),
        (all(n >= 1 for n in loops) and ranks[0]["loops_closed"] == ranks[1]["loops_closed"],
         f"loops closed per camera {loops}"),
        (all(r["pgo"]["dist"] < 0.3 * r["pgo"]["before"] and r["pgo"]["max_diff"] < 2e-4
             for r in ranks), "distributed PGO"),
        (all(r["ba"]["max_diff"] < 1e-3 and abs(r["ba"]["err_dist"] - r["ba"]["err_single"]) < 0.05
             for r in ranks), "distributed BA"),
        (all(r["shard_equal"] and r["shard_moved"] > 0 for r in ranks), "sharded K2 apply"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"collab: {what}")
    launches = {k: solo["launches"][k] + sum(r["launches"][k] for r in ranks)
                for k in ("gram", "deform", "zbuffer", "stamp", "track_iter")}
    fused_check("collab", launches, modes=False)
    shapes: dict = {}
    for r in [solo, *ranks]:
        for key, n in r["shapes"].items():
            shape = tuple(int(x) for x in key.split("x"))
            shapes[shape] = shapes.get(shape, 0) + n
    log(f"[collab] launches over the ranks: gram {launches['gram']}, deform {launches['deform']}; "
        f"gram by (P, C): {dict(sorted(shapes.items(), reverse=True))}")
    if launches["gram"] == 0 or launches["deform"] == 0:
        raise AssertionError(f"the collaborative session launched {launches}")
    return dict(launches=launches, shapes=shapes, fps_1=solo["fps"], fps_2=ranks[0]["fps"])


# the app leg: the port's entry points as a user starts them, at 640x480.
# Logs of the two-camera leg's orbit (camB's frames start 6 orbit frames
# ahead), rendered with the CLI's own camera (`CameraConfig.tum_default`)
APP_FRAMES = 30  # frames per log and of the single-camera run
APP_CKPT = 16  # the checkpoint check's frames (a checkpoint at half of them)
APP_LIVE, APP_LIVE_HZ = 30, 30.0
APP_ATE_MM = 20.0  # tests/test_checkpoint_cli.py:85
APP_CLI = ["--width", "640", "--height", "480", "--depth-cutoff", "8",
           "--max-surfels", str(1 << 20)]
# tests/test_checkpoint_cli.py's configuration, for the checkpoint the CPU writes
APP_CPU_CKPT = dict(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0,
                    nid_keyframing=False, open_loop=True)


def _cli_call(fn, argv: list) -> tuple:
    """Run `cli.main` or `cli.run` in this process; return (its result, its
    standard output, host seconds), the output echoed to the log."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[app]   cli: {line}")
    return out, buf.getvalue(), dt


def _cli_number(text: str, before: str, after: str) -> float:
    return float(text.split(before)[1].split(after)[0])


def _traj_ate_mm(path: str, gt: list) -> float:
    from densemonoslam_tpu_torch.io.datasets import load_freiburg_trajectory

    _, poses = load_freiburg_trajectory(path)
    if len(poses) != len(gt):
        raise AssertionError(f"{path}: {len(poses)} poses, expected {len(gt)}")
    return 1e3 * ate_rmse(list(poses), gt)


def _write_tum_dir(root, seq, n: int) -> tuple:
    """A TUM-layout directory (16-bit PNG depth at 5000 per metre, an
    association file) and its ground-truth trajectory."""
    from PIL import Image

    from densemonoslam_tpu_torch.io.writers import save_freiburg

    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines, stamps = [], []
    for i in range(n):
        rgb, depth = seq.frame(i)
        Image.fromarray(rgb).save(os.path.join(root, "rgb", f"{i}.png"))
        Image.fromarray((depth * 5000).astype(np.uint16)).save(
            os.path.join(root, "depth", f"{i}.png"))
        stamps.append(i / 30.0)
        lines.append(f"{stamps[-1]:.6f} rgb/{i}.png {stamps[-1]:.6f} depth/{i}.png")
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    gt = os.path.join(root, "groundtruth.freiburg")
    save_freiburg(gt, stamps, [seq.gt_pose(i) for i in range(n)])
    return gt


def _app_checkpoint(seq, frames: list) -> dict:
    """Resume on the card at 640x480: 16 frames uninterrupted, twice (the
    run-to-run bound), then 8 frames, `save_checkpoint`, `load_checkpoint`
    into a fresh engine and 8 more; then a checkpoint the CPU port wrote,
    loaded on the card."""
    import tempfile

    cfg = EngineConfig(**HEADLINE)
    camera = seq.camera

    def engine():
        eng = Engine(camera, cfg)
        eng.frontend("cam0").pose = seq.gt_pose(0).astype(np.float32)
        return eng

    def drive(eng, lo, hi):
        for i in range(lo, hi):
            eng.process_frame("cam0", *frames[i], float(i), sync=False)
        torch.cuda.synchronize()

    runs = []
    for _ in range(2):
        eng = engine()
        drive(eng, 0, APP_CKPT)
        runs.append(eng)
    half = APP_CKPT // 2
    eng_b = engine()
    drive(eng_b, 0, half)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        eng_b.save_checkpoint("cam0", path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        eng_c = engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng_c.load_checkpoint("cam0", path)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
    drive(eng_c, half, APP_CKPT)

    def gap(e1, e2):
        t1 = np.stack([p for _, p in e1.frontends["cam0"].trajectory])
        t2 = np.stack([p for _, p in e2.frontends["cam0"].trajectory])
        return float(np.abs(t1 - t2).max())

    run_to_run, resumed = gap(runs[0], runs[1]), gap(runs[0], eng_c)
    counts = [e.surfel_count("cam0") for e in (runs[0], runs[1], eng_c)]
    bound = max(run_to_run, 1e-6)  # the CPU test's atol where the runs agree bit for bit
    log(f"[app] checkpoint at 640x480: save {save_ms:.1f} ms ({size / 2**20:.1f} MiB), load "
        f"{load_ms:.1f} ms; largest pose difference over {APP_CKPT} frames: resumed "
        f"{resumed:.3e}, two uninterrupted runs {run_to_run:.3e} (bound {bound:.1e}); surfels "
        f"{counts[0]} / {counts[1]} / resumed {counts[2]}")
    if not resumed <= bound:
        raise AssertionError(f"resumed run differs by {resumed} > {bound}")
    if counts[2] != counts[0] or len(eng_c.frontends["cam0"].trajectory) != APP_CKPT:
        raise AssertionError(f"resumed run: {counts[2]} surfels vs {counts[0]}")
    del runs, eng_b, eng_c
    torch.cuda.empty_cache()

    # a checkpoint written by the port on the CPU, loaded on the card
    small = SyntheticSequence(num_frames=24, radius=0.35, max_angle=0.3)
    cpu = Engine(small.camera, EngineConfig(**APP_CPU_CKPT), device="cpu")
    cpu.frontend("cam0").pose = small.gt_pose(0).astype(np.float32)
    for i in range(4):
        cpu.process_frame("cam0", *small.frame(i), float(i))
    gpu = Engine(small.camera, EngineConfig(**APP_CPU_CKPT))
    gpu.frontend("cam0")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cpu.npz")
        cpu.save_checkpoint("cam0", path)
        gpu.load_checkpoint("cam0", path)
    want = stepmod.state_to_numpy(cpu.frontends["cam0"].state)
    got = stepmod.state_to_numpy(gpu.frontends["cam0"].state)
    if not (gpu.frontends["cam0"].state.map_data.is_cuda
            and all(np.array_equal(got[k], want[k]) for k in want)):
        raise AssertionError("the CPU-written checkpoint did not load bit for bit onto the card")
    for i in range(4, 8):
        cpu.process_frame("cam0", *small.frame(i), float(i))
        info = gpu.process_frame("cam0", *small.frame(i), float(i))
        if info["tracking_ok"] != 1.0:
            raise AssertionError(f"frame {i} after the CPU checkpoint lost tracking")
    dT = np.linalg.inv(cpu.frontends["cam0"].pose) @ gpu.frontends["cam0"].pose
    cross = float(np.linalg.norm(dT[:3, 3]))
    log(f"[app] a CPU-written checkpoint (160x120) loads bit for bit on the card; 4 more frames "
        f"on each: pose {cross * 1e3:.4f} mm apart (bound 0.5 mm, tests/test_torch_cuda.py)")
    if not (cross < 5e-4 and _rot_err(dT[:3, :3]) < 1e-3):
        raise AssertionError(f"card and CPU part by {cross} m after the CPU checkpoint")
    return dict(save_ms=save_ms, load_ms=load_ms, resumed=resumed, run_to_run=run_to_run)


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _app_live(cli, port: int, frames: list) -> dict:
    """A sender thread paced at 30 Hz streams frames over loopback UDP to
    `cli.main(["--live-port", ...])`; sent, received and processed counts."""
    import threading

    from densemonoslam_tpu_torch.io.stream import FrameSender

    sent = []

    def send():
        time.sleep(3.0)  # the CLI binds its receiver first
        tx = FrameSender("live0", port=port)
        try:
            t0 = time.perf_counter()
            for k, (rgb, depth) in enumerate(frames):
                tx.send(rgb, (depth * 1000).astype(np.uint16), timestamp=k,
                        last=k == len(frames) - 1)
                sent.append(k)
                time.sleep(max(0.0, t0 + (k + 1) / APP_LIVE_HZ - time.perf_counter()))
        finally:
            tx.close()

    th = threading.Thread(target=send, daemon=True)
    th.start()
    try:
        _, text, dt = _cli_call(cli.main, ["--live-port", str(port), "--num-sensors", "1",
                                           "--frames", str(len(frames)), *APP_CLI])
    finally:
        th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("the live sender did not finish")
    processed = int(_cli_number(text, "processed ", " frames"))
    received = int(_cli_number(text, "live frames received ", ","))
    pushed = int(_cli_number(text, "pushed out of the full queue ", "\n"))
    log(f"[app] live: frames sent {len(sent)}, received {received} (lost by UDP "
        f"{len(sent) - received}), pushed out of the receiver's queue {pushed}, processed "
        f"{processed}, in {dt:.1f} s")
    if processed < 1 or processed + pushed != received:
        raise AssertionError(f"live stream: {processed} processed, {received} received")
    return dict(sent=len(sent), received=received, pushed=pushed, processed=processed)


def _app_viewer(eng) -> dict:
    """Serve the two-camera session's engine and fetch what the page polls."""
    import urllib.request

    from densemonoslam_tpu_torch.viewer import ViewerServer

    srv = ViewerServer(eng, port=0)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    cams = list(eng.frontends)
    try:
        pub = []
        for cam in cams:
            t0 = time.perf_counter()
            srv.publish(cam)
            pub.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        srv.sync(cams)  # the first cloud refresh of every map
        cloud_ms = 1e3 * (time.perf_counter() - t0)

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.read()

        st = json.loads(get("/api/status"))
        n_png = 0
        for cam in cams:
            for kind in ("rgb", "depth", "normals"):
                if get(f"/api/view/{cam}/{kind}.png")[:8] != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"view {cam}/{kind} is not a PNG")
                n_png += 1
        blobs = {}
        for m in eng.maps:
            blob = get(f"/api/cloud/{m}")
            (n,) = struct.unpack_from("<I", blob, 0)
            if n == 0 or len(blob) != 4 + 15 * n:
                raise AssertionError(f"cloud of map {m}: {n} points in {len(blob)} bytes")
            blobs[m] = n
    finally:
        srv.stop()
    if sorted(st["cams"]) != sorted(cams) or not all(
            be.map_data.is_cuda for be in eng.maps.values()):
        raise AssertionError(f"viewer status {st['cams'].keys()} / maps off the card")
    log(f"[app] viewer: status of {len(st['cams'])} cameras, {n_png} view PNGs, clouds "
        f"{blobs} points; publish {', '.join(f'{x:.1f}' for x in pub)} ms per camera (host), "
        f"one cloud refresh of {len(blobs)} map(s) {cloud_ms:.1f} ms (host; the gather on the "
        f"card)")
    return dict(publish_ms=pub, cloud_ms=cloud_ms)


def phase_app() -> dict:
    """The application layer on the card: the host probe, the CLI on `.klg`
    logs (one camera, then two), the single-camera `main()` path with its
    exports, checkpoint/resume, a live UDP stream and the viewer."""
    import shutil
    import tempfile

    from densemonoslam_tpu_torch import cli
    from densemonoslam_tpu_torch.io import native
    from densemonoslam_tpu_torch.io.klg import write_klg

    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    have_native, have_pf = native.HAVE_NATIVE, native.HAVE_PREFETCH
    log(f"[app] host: PIL {pil or 'missing'}; native codec built and loaded: {have_native} "
        f"(prefetcher {have_pf})" + ("" if have_native else f"; build failed: {native.BUILD_ERROR}"))
    compress = have_native or pil is not None
    log(f"[app] .klg logs written with compress={compress} "
        + ("(zlib depth + JPEG RGB)" if compress else "(raw: no JPEG codec on this host)"))

    camera = CameraConfig.tum_default("app")
    seq = SyntheticSequence(camera=camera, num_frames=40, radius=0.35, max_angle=0.3)
    n = APP_FRAMES
    # one 640x480 frame takes the host ~0.4 s to render: a spawned pool
    with multiprocessing.get_context("spawn").Pool(min(6, os.cpu_count() or 1)) as pool:
        frames = pool.map(seq.frame, range(MULTI_OFFSET + n))
    launches, shapes, fps = dict(gram=0, deform=0, zbuffer=0, stamp=0, track_iter=0), {}, {}

    def count(label):
        settle()
        k1, k2 = klaunches.total("gram"), klaunches.total("deform")
        launches["gram"] += k1
        launches["deform"] += k2
        launches["stamp"] += klaunches.total("stamp")
        launches["track_iter"] += klaunches.total("track_iter")
        launches["zbuffer"] += klaunches.total("zbuffer")
        for shape, k in klaunches.by_shape("gram").items():
            shapes[shape] = shapes.get(shape, 0) + k
        log(f"[app] {label}: K1 {k1} launches, K2 {k2}")
        if k1 == 0:
            raise AssertionError(f"{label}: no K1 launch, the run did not track on the card")

    work = tempfile.mkdtemp(prefix="app_")
    try:
        logs = []
        for name, start in (("a", 0), ("b", MULTI_OFFSET)):
            logs.append(os.path.join(work, f"{name}.klg"))
            write_klg(logs[-1], [(rgb, (depth * 1000).astype(np.uint16), i)
                                 for i, (rgb, depth) in enumerate(frames[start:start + n])],
                      compress=compress)
        gts = [[seq.gt_pose(i) for i in range(start, start + n)] for start in (0, MULTI_OFFSET)]

        # one camera from a log
        out = os.path.join(work, "one")
        reset_counts()
        _, text, dt = _cli_call(cli.main, ["--logs", logs[0], "--frames", str(n), "--out", out,
                                           *APP_CLI])
        count("one log")
        ate = _traj_ate_mm(os.path.join(out, "cam0.freiburg"), gts[0])
        fps["one log"] = _cli_number(text, " cameras at ", " fps")
        dispatch = _cli_number(text, "frame_dispatch mean ", " ms")
        log(f"[app] one log: {n} frames, {fps['one log']:.2f} fps (CLI), frame_dispatch mean "
            f"{dispatch:.2f} ms, ATE {ate:.3f} mm (bound {APP_ATE_MM} mm), {dt:.1f} s; exports "
            f"{sorted(os.listdir(out))}")
        if not (ate < APP_ATE_MM and os.path.exists(os.path.join(out, "cam0.ply"))):
            raise AssertionError(f"one log: ATE {ate} mm or the exports are missing")

        # two cameras from two logs; the engine stays for the viewer
        out = os.path.join(work, "two")
        reset_counts()
        eng, text, dt = _cli_call(cli.run, ["--logs", *logs, "--frames", str(n), "--out", out,
                                            *APP_CLI])
        count("two logs")
        if eng.device.type != "cuda":
            raise AssertionError(f"the CLI ran on {eng.device}")
        ates = [_traj_ate_mm(os.path.join(out, f"cam{k}.freiburg"), gts[k]) for k in (0, 1)]
        plys = [f for f in os.listdir(out) if f.endswith(".ply")]
        fps["two logs"] = _cli_number(text, " cameras at ", " fps")
        log(f"[app] two logs: {2 * n} camera-frames, {fps['two logs']:.2f} camera-frames/s "
            f"(CLI), frame_dispatch mean {eng.timer.mean('frame_dispatch'):.2f} ms, maps "
            f"{ {m: eng.surfel_count(m) for m in eng.maps} }, ATE cam0 {ates[0]:.3f} mm, cam1 "
            f"{ates[1]:.3f} mm, {dt:.1f} s; exports {sorted(os.listdir(out))}")
        if not (max(ates) < APP_ATE_MM and len(plys) == len(eng.maps)):
            raise AssertionError(f"two logs: ATE {ates} mm, {plys} for maps {list(eng.maps)}")
        viewer = _app_viewer(eng)
        del eng
        torch.cuda.empty_cache()

        # the single-camera main() path with its four exports
        out = os.path.join(work, "main")
        reset_counts()
        if pil is not None:
            gt = _write_tum_dir(os.path.join(work, "tum"), seq, n)
            argv = ["--dataset", "tum", "--path", os.path.join(work, "tum"), "--gt", gt,
                    "--frames", str(n), "--depth-cutoff", "8", "--max-surfels", str(1 << 20)]
            which = f"a TUM-layout directory at 640x480, {n} frames"
        else:
            argv = ["--dataset", "synthetic", "--frames", str(n), "--max-surfels", str(1 << 20)]
            which = f"--dataset synthetic (160x120: no PIL here for TUM PNGs), {n} frames"
        _, text, dt = _cli_call(cli.main, [*argv, "--out", out])
        count("main")
        ate = float(text.split("ATE RMSE")[1].split(":")[1].split("mm")[0])
        fps["main"] = _cli_number(text, " frames at ", " fps")
        dispatch = _cli_number(text, "frame_dispatch mean ", " ms")
        exports = sorted(os.listdir(out))
        log(f"[app] main() on {which}: {fps['main']:.2f} fps (CLI), frame_dispatch mean "
            f"{dispatch:.2f} ms, ATE {ate:.3f} mm, {dt:.1f} s; exports {exports}")
        if exports != ["map.ply", "run.stats", "timings.csv", "trajectory.freiburg"]:
            raise AssertionError(f"main(): exports {exports}")
        if not ate < APP_ATE_MM:
            raise AssertionError(f"main(): ATE {ate} mm")

        reset_counts()
        ckpt = _app_checkpoint(seq, frames)
        count("checkpoint")

        reset_counts()
        live = _app_live(cli, _free_udp_port(), frames[:APP_LIVE])
        count("live")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[app] K1 {launches['gram']} launches, K2 {launches['deform']} over the leg; K1 by "
        f"(P, C): {dict(sorted(shapes.items(), reverse=True))}")
    fused_check("app", launches, modes=False)
    return dict(launches=launches, shapes=dict(sorted(shapes.items(), reverse=True)), fps=fps,
                ckpt=ckpt, live=live, viewer=viewer)


# ---------------------------------------------------------------------------
# the train leg: the depth CNN's trainers (`examples/torch_train_depthnet.py`,
# `examples/torch_train_depthnet_street.py`) at their own configurations on
# the card, then the card-trained net driving the monocular engine
# ---------------------------------------------------------------------------

# card against CPU from one initialisation: each parameter's gradient
# (relative norm) and the 5 steps' losses (relative).  cuDNN sums in another
# order than the CPU's convolutions, and its weight gradients may use atomics
TRAIN_TOL = 1e-3
TRAIN_STREET_BOUND = 0.20  # held-out relative depth error, at both resolutions
# tests/test_depthnet.py:164-206, the monocular engine on a trained net
TRAIN_MONO = dict(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0,
                  nid_keyframing=False, open_loop=True, predict_depth=True)
TRAIN_MONO_FRAMES, TRAIN_MONO_REL, TRAIN_MONO_ATE_M = 10, 0.12, 0.15
# (H, W), batch: the trainers' three step shapes
TRAIN_STEP_SHAPES = [((120, 160), 4), ((80, 256), 4), ((320, 1024), 2)]


def _train_batch(frames: list) -> tuple:
    rgb = torch.from_numpy(np.stack([f[0] for f in frames]).astype(np.float32) / 255.0)
    return rgb, torch.from_numpy(np.stack([f[1] for f in frames]))


def _train_card_against_cpu(mod, frames: list) -> dict:
    """From one flax-style initialisation (seed 0) and the synthetic
    trainer's first 4 views: each parameter's gradient of `l1_depth_loss` on
    the card against the CPU's, then 5 train steps on each."""
    from densemonoslam_tpu_torch.models.depthnet import DepthNet, l1_depth_loss, make_train_step

    rgb, gt = _train_batch(frames[:4])
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        net = DepthNet(mod.WIDTHS, mod.MIN_D, mod.MAX_D, seed=0).to(dev)
        l1_depth_loss(net(rgb.to(dev).permute(0, 3, 1, 2)), gt.to(dev)).backward()
        grads[dev] = {k: p.grad.double().cpu() for k, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=mod.LR,
                                                     betas=(0.9, 0.999), eps=1e-8))
        losses[dev] = torch.stack([step(rgb.to(dev), gt.to(dev)) for _ in range(5)]).cpu().numpy()
    rel = {k: float((grads["cuda"][k] - g).norm() / g.norm()) for k, g in grads["cpu"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    log(f"[train] card against CPU, {len(rel)} parameters at {tuple(rgb.shape[:3])}: largest "
        f"relative gradient difference {rel[worst]:.3e} ({worst}; median "
        f"{statistics.median(rel.values()):.3e}); 5 steps' losses card "
        f"{np.array2string(losses['cuda'], precision=6)}, CPU "
        f"{np.array2string(losses['cpu'], precision=6)}, largest relative difference "
        f"{loss_rel:.3e} (tolerance {TRAIN_TOL:g} for both)")
    if not (rel[worst] <= TRAIN_TOL and loss_rel <= TRAIN_TOL):
        raise AssertionError(f"card against CPU: gradient {rel[worst]} ({worst}), loss {loss_rel}")
    return dict(grad_rel=rel[worst], loss_rel=loss_rel)


def _train_mono(mod, path: str) -> dict:
    """`tests/test_depthnet.py:164-206` on the card with the card-trained
    weights: the depth of a view of the scene, then 10 RGB-only frames of the
    monocular engine (K1 on every tracked frame)."""
    pred = DepthPredictor(widths=mod.WIDTHS, min_depth=mod.MIN_D, max_depth=mod.MAX_D)
    pred.load(path)
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    rgb, depth = seq.frame(0)
    d_hat = pred.predict(rgb).cpu().numpy()
    m = depth > 0
    rel = float(np.mean(np.abs(d_hat[m] - depth[m]) / depth[m]))
    eng = Engine(seq.camera, EngineConfig(**TRAIN_MONO))
    eng.frontend("cam0")
    eng.set_depth_predictor(pred)
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    reset_counts()
    n_ok = 0
    for i in range(TRAIN_MONO_FRAMES):
        info = eng.process_frame("cam0", seq.frame(i)[0], None, float(i))
        n_ok += info["tracking_ok"] == 1.0
    torch.cuda.synchronize()
    launches = counts()
    shapes = by_shape()
    fused_check("train", launches)
    est = [p for _, p in eng.frontends["cam0"].trajectory]
    ate = float(ate_rmse(est, [seq.gt_pose(i) for i in range(TRAIN_MONO_FRAMES)]))
    log(f"[train] the card-trained net in the monocular engine: frame 0 relative depth error "
        f"{rel * 100:.2f}% (bound {TRAIN_MONO_REL * 100:.0f}%); {n_ok} of {TRAIN_MONO_FRAMES} "
        f"RGB-only frames tracked (bound 8), ATE {ate:.4f} m (bound {TRAIN_MONO_ATE_M}), "
        f"{eng.surfel_count('cam0')} surfels; K1 {launches['gram']} launches {shapes}, "
        f"K2 {launches['deform']}")
    if not (rel < TRAIN_MONO_REL and n_ok >= 8 and ate < TRAIN_MONO_ATE_M):
        raise AssertionError(f"monocular engine on the trained net: rel {rel}, {n_ok} tracked, "
                             f"ATE {ate} m")
    if launches["gram"] == 0:
        raise AssertionError("the monocular engine launched no K1: it did not track on the card")
    return dict(rel=rel, tracked=int(n_ok), ate_m=ate, launches=launches, shapes=shapes)


def _train_step_ms(mod, hw: tuple, batch: int) -> float:
    """Median ms of one synchronised train step of the trainers' net at
    (H, W) and `batch`, over 20 steps after 3 warm-up steps."""
    from densemonoslam_tpu_torch.models.depthnet import DepthNet, make_train_step

    net = DepthNet(mod.WIDTHS, mod.MIN_D, mod.MAX_D, seed=0).cuda()
    step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=mod.LR))
    gen = np.random.default_rng(0)
    rgb = torch.from_numpy(gen.uniform(0, 1, (batch, *hw, 3)).astype(np.float32)).cuda()
    gt = torch.from_numpy(gen.uniform(mod.MIN_D, mod.MAX_D, (batch, *hw)).astype(np.float32)).cuda()
    return call_ms(lambda: step(rgb, gt), n=20)


def phase_train(frames: dict, smi: str) -> dict:
    """The depth CNN's training on the card: (a) card against CPU from one
    start, (b) the synthetic trainer at its own configuration (600 steps,
    its own <10% held-out assertion, the loss halved), (c) the street
    trainer at its own (800 steps, both held-out errors < 20%, the loss
    halved), (d) (b)'s weights loaded through `DepthPredictor.load` driving
    the monocular engine; then ms per train step at the trainers' shapes."""
    import shutil
    import tempfile

    from densemonoslam_tpu_torch.models.depthnet import WEIGHTS_DIR

    syn_mod = _example("torch_train_depthnet")
    street_mod = _example("torch_train_depthnet_street")
    syn_frames = [f for k in range(len(syn_mod.ORBITS)) for f in frames[f"train_syn{k}"]]
    street_frames = frames["train_street0"] + frames["train_street1"]
    torch.cuda.reset_peak_memory_stats()
    a = _train_card_against_cpu(syn_mod, syn_frames)
    out = tempfile.mkdtemp(prefix="train_")
    try:
        syn = syn_mod.train(syn_frames, device="cuda", out=out)
        street = street_mod.train(street_frames, frames["train_kitti"], device="cuda", out=out)
        for name, res in (("synthetic", syn), ("street", street)):
            if not res["losses"][-1] < 0.5 * res["losses"][0]:
                raise AssertionError(f"{name} trainer: loss {res['losses'][0]} -> "
                                     f"{res['losses'][-1]}, not halved")
        if not (street["rel"] < TRAIN_STREET_BOUND and street["rel_kitti"] < TRAIN_STREET_BOUND):
            raise AssertionError(f"street trainer: held-out errors {street['rel']}, "
                                 f"{street['rel_kitti']}")
        mono = _train_mono(syn_mod, syn["path"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    step_ms = {(hw, b): _train_step_ms(syn_mod, hw, b) for hw, b in TRAIN_STEP_SHAPES}
    with open(WEIGHTS_DIR / "depthnet_street.json") as f:
        jax_run = json.load(f)  # the packaged street weights' run (JAX)
    for name, res in (("synthetic", syn), ("street", street)):
        log(f"[train] {name} trainer: {res['steps']} steps in {res['train_s']:.2f} s, "
            f"{res['steps'] / res['train_s']:.1f} steps/s; loss {res['losses'][0]:.4f} -> "
            f"{res['losses'][-1]:.4f}")
    log(f"[train] held-out relative depth error: synthetic {syn['rel'] * 100:.2f}% (bound 10%); "
        f"street 256x80 {street['rel'] * 100:.2f}%, 1024x320 {street['rel_kitti'] * 100:.2f}% "
        f"(bound {TRAIN_STREET_BOUND * 100:.0f}%; the JAX run of the packaged street weights: "
        f"{jax_run['held_out_rel_err'] * 100:.2f}%, "
        f"{jax_run['held_out_rel_err_kitti'] * 100:.2f}%)")
    log(f"[train] ms per train step (synchronised, median of 20): "
        + ", ".join(f"{w}x{h} batch {b} {ms:.3f} ms" for ((h, w), b), ms in step_ms.items())
        + f"; peak device memory {peak / 2**20:.1f} MiB; {smi}")
    return dict(card_vs_cpu=a, syn_rel=syn["rel"], street_rel=street["rel"],
                street_rel_kitti=street["rel_kitti"], mono=mono, step_ms=step_ms, peak=peak,
                launches=mono["launches"], shapes=mono["shapes"])


# ---------------------------------------------------------------------------
# the measurement entry points: torch_bench's legs the other phases do not
# run, the per-stage profile of the step and K2 on profile_closure's map
# ---------------------------------------------------------------------------

# timed frames of each torch_bench leg here: BENCH_FRAMES's default, so that
# the orbit is the headline's (the orbit spans warm-up + timed frames; at 10
# timed frames its steps are 2.4x as long and the open loop's ATE is 89 mm)
BENCH_TIMED = 30
BENCH_ATE_MM = 10.0  # tests/test_engine.py's bound, on the headline orbit's legs


def _bench_leg(tb, name: str, *args, **kw) -> dict:
    """One `torch_bench._run_slam` leg on the card: fps, ATE, peak device
    memory; every frame tracked and its stats finite."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fps, ate_mm, eng, _, _ = tb._run_slam(*args, **kw, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    stats = torch.stack(eng.frontends["cam0"].stats_log).cpu().numpy()
    surfels = eng.surfel_count("cam0")
    log(f"[bench] {name}: {fps:.2f} fps over {args[2]} timed frames, ATE {ate_mm:.4f} mm, "
        f"surfels {surfels}, peak device memory {peak / 2**20:.1f} MiB")
    if not np.isfinite(stats).all():
        raise AssertionError(f"bench leg {name}: non-finite stats")
    if not (stats[:, stepmod.STAT_TRACK_OK] == 1.0).all():
        raise AssertionError(f"bench leg {name}: tracking lost at frames "
                             f"{np.nonzero(stats[:, stepmod.STAT_TRACK_OK] != 1.0)[0]}")
    return dict(fps=fps, ate_mm=ate_mm, peak=peak, surfels=surfels)


def phase_bench() -> dict:
    """`torch_bench.py`'s legs that no other phase runs, at `BENCH_TIMED`
    timed frames (tracking and finite stats on every leg, ATE within
    `BENCH_ATE_MM` on the headline orbit's): the open loop beside
    relocalisation (the overhead), the 1024x320 orbit, the default
    configuration and the 1<<25-row map; then
    `examples/torch_profile_stages.py` at 640x480 (every stage timed; a
    device time the profiler lost is NaN and logged); then K2 against its
    plain version on `examples/torch_profile_closure.py`'s map (1<<22 rows,
    half of the 2,097,152 live ones inactive) with the graph that profile's
    closure applies."""
    tb = _repo_module("torch_bench.py")
    reset_counts()  # count only this path's launches from here
    legs = {
        "open loop": _bench_leg(tb, "open loop", 640, 480, BENCH_TIMED, 4, dict(open_loop=True)),
        "relocalisation": _bench_leg(tb, "relocalisation", 640, 480, BENCH_TIMED, 4,
                                     dict(open_loop=True, relocalisation=True)),
        "1024x320": _bench_leg(tb, "1024x320", 1024, 320, BENCH_TIMED, 4, dict(open_loop=True),
                               intr=CameraIntrinsics(707.09, 707.09, 601.89, 183.11)),
        "default config": _bench_leg(tb, "default config", 640, 480, BENCH_TIMED, 4,
                                     dict(open_loop=True),
                                     base_cfg=dict(pyramid_levels=3, track_row_stride=1)),
        "1<<25 capacity": _bench_leg(tb, "1<<25 capacity", 640, 480, BENCH_TIMED, 4,
                                     dict(open_loop=True, max_surfels=1 << 25)),
    }
    overhead = 100.0 * (1.0 - legs["relocalisation"]["fps"] / legs["open loop"]["fps"])
    log(f"[bench] relocalisation overhead {overhead:.1f}% of the open loop's fps "
        f"(bench.py's claim: < 10%); 1<<25 rows against 1<<20: "
        f"{legs['1<<25 capacity']['fps']:.2f} / {legs['open loop']['fps']:.2f} fps, ATE "
        f"{legs['1<<25 capacity']['ate_mm']:.6f} / {legs['open loop']['ate_mm']:.6f} mm")
    for name in ("open loop", "relocalisation", "1<<25 capacity"):
        if not legs[name]["ate_mm"] < BENCH_ATE_MM:
            raise AssertionError(f"bench leg {name}: ATE {legs[name]['ate_mm']:.3f} mm")
    t0 = time.perf_counter()
    stages = _example("torch_profile_stages").main(["--width", "640", "--height", "480"])
    log(f"[bench] torch_profile_stages at 640x480: {time.perf_counter() - t0:.1f} s")
    lost = [k for k, v in stages["device_ms"].items() if math.isnan(v)]
    if lost:
        log(f"[bench] torch_profile_stages: the profiler kept no device event of {lost}")
    device = [v for v in stages["device_ms"].values() if not math.isnan(v)]
    if not all(v > 0 for v in (*stages["wall_ms"].values(), *device)):
        raise AssertionError(f"torch_profile_stages: a stage without time: {stages}")
    launches = counts()  # before K2's checks
    shapes = by_shape()
    fused_check("bench", launches)
    log(f"[bench] launches: gram {launches['gram']}, deform {launches['deform']}; "
        f"gram by (P, C): {shapes}")
    if launches["gram"] == 0:
        raise AssertionError("the bench legs launched no gram kernel")
    pc = _example("torch_profile_closure")
    state = pc.build_state(device="cuda")
    cfg = pc.config()
    intr = CameraIntrinsics.default_for(FrameResolution(pc.W, pc.H))
    graph = pc.closure_graph(state, cfg, intr)
    n_live = int(state.map_count)
    k2 = [_deform_checks(f"profile_closure map ({n_live} live), its closure's "
                         f"{int(graph.valid.sum())}-node graph",
                         state.map_data, state.map_count, graph)]
    return dict(legs=legs, overhead=overhead, stages=stages, k2=k2, launches=launches,
                shapes=shapes)


def _k3_entry(k3: dict, launches) -> dict:
    """K3's entry of the kernels line (`launches`: the legs' full renders,
    None where no leg ran)."""
    return {
        "name": "zbuffer",
        "route": "cuda",
        "source": "densemonoslam_tpu_torch/csrc/zbuffer.cu",
        "replaces": None,
        "launches": launches,
        "launches_per_call": k3["launches_per_call"],
        "max_abs_err": k3["max_rel_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA GPU")
    if sys.argv[1:] == ["--k3"]:  # K3's phase alone
        smi = phase_device()
        k3 = phase_zbuffer()
        log(smi)
        print(json.dumps({"kernels": [_k3_entry(k3, None)]}))
        return 0
    if sys.argv[1:2] == ["--collab-rank"]:  # one rank of `phase_collab`'s session
        res = collab_rank(sys.argv[2])
        print("RESULT " + json.dumps(res), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    street = HostRender()  # forks its workers before any CUDA work
    try:
        return run(street)
    finally:
        street.stop()


def run(street: HostRender) -> int:
    smi = phase_device()
    clock = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        log(f"[time] {name}: {now - clock:.1f} s")
        clock = now

    reset_counts()
    k1 = phase_gram()
    k1_launches = counts()["gram"]
    lap("K1")
    fused = phase_track_iter()
    torch.cuda.empty_cache()
    lap("fused tracking iteration")
    slam = phase_slam()
    phase_profile(slam["engine"], slam["frames"])
    del slam["engine"], slam["frames"]
    torch.cuda.empty_cache()
    lap("open loop")
    gph = phase_graphs()
    torch.cuda.empty_cache()
    lap("graphs")
    odo = phase_odometry()
    torch.cuda.empty_cache()
    lap("odometry")
    k2_synth = phase_deform_synthetic()
    lap("K2 synthetic")
    k3 = phase_zbuffer()
    torch.cuda.empty_cache()
    lap("K3")
    closed = phase_closed_loop()
    lap("closed loop")
    k2_real = _deform_checks(
        "closed-loop map, last closure's graph", closed["data"], closed["count"], closed["graph"]
    )
    del closed["data"], closed["graph"]
    torch.cuda.empty_cache()
    lap("K2 on the closed-loop map")
    reloc = phase_relocalisation()
    lap("relocalisation")
    street_frames = street.host_frames("mono")["mono"]
    mono = phase_mono_street(street.seq, street_frames)
    torch.cuda.empty_cache()
    lap("mono street")
    phase_street_sparse(street.seq, street_frames)
    del street_frames
    lap("street sparse lap")
    hybrid = phase_hybrid_closure()
    torch.cuda.empty_cache()
    lap("hybrid closure")
    two = phase_two_cameras()
    torch.cuda.empty_cache()
    lap("two cameras")
    collab = phase_collab()
    lap("collab session")
    app = phase_app()
    torch.cuda.empty_cache()
    lap("app")
    train = phase_train(street.host_frames("train"), smi)
    torch.cuda.empty_cache()
    lap("train")
    bench = phase_bench()
    torch.cuda.empty_cache()
    lap("bench")
    # the legs' K1 launches per (P, C), every one a fused tracking iteration
    # (`fused_check`); `gram(M)` (csrc/gram.cu) runs only in its own checks
    legs = {"open": slam["shapes"], "odometry": odo["shapes"], "closed": closed["shapes"],
            "reloc": reloc["shapes"],
            "mono": mono["shapes"], "two cameras": two["shapes"], "collab": collab["shapes"],
            "app": app["shapes"], "train": train["shapes"], "bench": bench["shapes"]}
    for shape in sorted({shape for leg in legs.values() for shape in leg}, reverse=True):
        n = sum(leg.get(shape, 0) for leg in legs.values())
        split = ", ".join(f"{k} {leg.get(shape, 0)}" for k, leg in legs.items())
        log(f"[track_iter] {shape[0]}x{shape[1]} in K1's terms: {n} fused launches ({split})")
    k1["max_abs_err"] = max(k1["max_abs_err"], odo["block_err"])
    # each leg's K1 launches and, of them, fused iterations (equal in every
    # leg, `fused_check`): what is left are gram(M)'s own on the main paths
    counted = {"open": (slam["launches"], slam["fused"]),
               "reloc": (reloc["launches"], reloc["fused"]),
               **{k: (leg["launches"]["gram"], leg["launches"]["track_iter"]) for k, leg in
                  (("odometry", odo), ("closed", closed), ("mono", mono), ("two cameras", two),
                   ("collab", collab), ("app", app), ("train", train), ("bench", bench))}}
    fused_n = sum(f for _, f in counted.values())
    gram_main = sum(g - f for g, f in counted.values())
    gram_n = k1_launches + fused["chain_k1"] + odo["block_launches"] + gram_main
    log(f"[track_iter] fused launches over every leg: {fused_n} "
        f"({', '.join(f'{k} {f}' for k, (_, f) in counted.items())}); per track: "
        f"{fused['tracks']}")
    log(f"[gram] gram(M) launches: {gram_n} (its phase-1 checks {k1_launches}, phase 1b's "
        f"op-by-op chains {fused['chain_k1']}, the odometry leg's row blocks "
        f"{odo['block_launches']}, the legs' main paths {gram_main})")
    lap("K1 per shape")
    g = k1["times"][GRAM_SHAPES[0]]
    head = fused["times"][("revisit", 76800, 16)]
    # every map K2 was held against its plain version on; the entry's
    # times are those of the closed-loop map, where most of its launches are
    k2_checks = [k2_synth, k2_real, mono["k2"], hybrid["k2"], *bench["k2"]]
    log(smi)
    print(json.dumps({"kernels": [
        {
            "name": "gram",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/gram.cu",
            "replaces": "densemonoslam_tpu/ops/pallas/gram.py:66",
            "launches": gram_n,
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
            "name": "track_iter",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/track_iter.cu",
            "replaces": "densemonoslam_tpu/ops/pallas/gram.py:66 with the row build, solve and "
                        "update around it (densemonoslam_tpu/tracking/odometry.py)",
            "launches": fused_n,
            "launches_per_call": 1,
            "max_abs_err": head["pose_err"],
            "ms": head["fused_ms"]["frozen"],
            "prev_ms": head["chain_ms"]["frozen"],
            "plain_ms": head["chain_ms"]["frozen"],
            "bound_ms": head["bound_ms"]["frozen"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "deform",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/deform.cu",
            "replaces": "densemonoslam_tpu/ops/pallas/deform.py:201",
            "launches": odo["launches"]["deform"] + closed["launches"]["deform"]
            + mono["launches"]["deform"]
            + hybrid["launches"] + two["launches"]["deform"] + collab["launches"]["deform"]
            + app["launches"]["deform"] + train["launches"]["deform"]
            + bench["launches"]["deform"],
            "max_abs_err": max(c["max_abs_err"] for c in k2_checks),
            "ms": k2_real["ms"],
            "prev_ms": k2_real["prev_ms"],
            "plain_ms": k2_real["plain_ms"],
            "bound_ms": k2_real["bound_ms"],
            "bound_by": k2_real["bound_by"],
            "library_ms": None,
            "shapes": k2_checks,
        },
        _k3_entry(k3, sum(leg["launches"]["zbuffer"] for leg in (
            odo, closed, mono, two, collab, app, train, bench))),
        {
            "name": "graph_if",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/graph_if.cu",
            "replaces": "densemonoslam_tpu/step.py:407",
            "launches": gph["ifs"],
            "max_abs_err": gph["if_check"]["max_abs_err"],
            "ms": gph["if_check"]["ms"],
            "plain_ms": gph["if_check"]["plain_ms"],
            "bound_ms": gph["if_check"]["bound_ms"],
            "bound_by": gph["if_check"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "stamp",
            "route": "cuda",
            "source": "densemonoslam_tpu_torch/csrc/stamp.cu",
            "replaces": None,
            "launches": slam["stamps"] + gph["stamps"] + odo["launches"]["stamp"]
            + closed["launches"]["stamp"] + reloc["stamps"] + mono["launches"]["stamp"]
            + two["launches"]["stamp"] + collab["launches"]["stamp"] + app["launches"]["stamp"]
            + train["launches"]["stamp"] + bench["launches"]["stamp"],
            "max_abs_err": gph["stamp_check"]["max_abs_err"],
            "ms": gph["stamp_check"]["ms"],
            "plain_ms": gph["stamp_check"]["plain_ms"],
            "bound_ms": gph["stamp_check"]["bound_ms"],
            "bound_by": gph["stamp_check"]["bound_by"],
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
