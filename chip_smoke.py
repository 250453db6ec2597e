"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

0. device: requires CUDA, prints the card's name and power limit, builds the
   hand-written kernels from `densemonoslam_tpu_torch/csrc/` with nvcc;
1. kernel K1 (Gram reduction) against its plain PyTorch version at the
   tracking shapes: f64 agreement, zero-padding invariance, bit-identical
   reruns, and both times per shape;
2. the main path: `Engine(device="cuda")` on the 640x480 synthetic orbit at
   the headline configuration (1<<20-surfel map, 4 pyramid levels, row
   stride 2, NID keyframing, open loop): 4 warm-up + 30 timed frames, with
   tracking, ATE, map size and kernel-launch checks.  Then one compaction of
   the resulting map;
3. where the time goes: 8 more frames under `torch.profiler`, with the
   device-busy share, device operations per frame and the top operations.

The last two lines are a JSON summary of the kernels and the JSON verdict.
"""

from __future__ import annotations

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
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.eval import ate_rmse
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import gram
from densemonoslam_tpu_torch.tracking import odometry

GRAM_SHAPES = [(76800, 16), (19200, 16), (4800, 16), (4800, 8), (5000, 8)]
GRAM_TOL = dict(rtol=2e-5, atol=1e-2)  # tests/test_pallas.py's tolerance
N_WARMUP, N_TIMED = 4, 30
RES = (640, 480)
HEADLINE = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=True,
    nid_threshold=0.85, pyramid_levels=4, track_row_stride=2, open_loop=True,
)


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
    """Mean device time of the kernels one call launches, from
    `torch.profiler` over `n` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return _device_us(prof)[0] / n / 1e3


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
    lib = gram.build()
    log(f"[phase 0] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    return smi


def phase_gram() -> dict:
    gen = np.random.default_rng(0)
    worst = 0.0
    times = {}
    for P, C in GRAM_SHAPES:
        M = torch.from_numpy(gen.normal(0, 1, (P, C)).astype(np.float32)).cuda()
        out = gram.gram(M)
        again = gram.gram(M)
        padded = gram.gram(torch.cat([M, torch.zeros(3000, C, device="cuda")]))
        torch.cuda.synchronize()
        ref = gram.gram_reference(M.double())
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **GRAM_TOL)
        err = float((out.double() - ref).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, again):
            raise AssertionError(f"gram {P}x{C}: two runs differ")
        if not torch.equal(out, padded):
            raise AssertionError(f"gram {P}x{C}: zero padding changed the result")
        kernel, plain = (lambda: gram.gram(M)), (lambda: gram.gram_reference(M))
        k_call, p_call = call_ms(kernel), call_ms(plain)
        k_dev, p_dev = device_ms(kernel), device_ms(plain)
        times[(P, C)] = (k_dev, p_dev)
        log(f"[phase 1] gram {P:6d}x{C:<2d} max|err| {err:.3e}  device: kernel "
            f"{k_dev * 1e3:7.2f} us, plain {p_dev * 1e3:7.2f} us;  call: kernel "
            f"{k_call * 1e3:7.2f} us, plain {p_call * 1e3:7.2f} us")
    return dict(max_abs_err=worst, times=times)


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


def phase_slam() -> dict:
    W, H = RES
    camera = CameraConfig(
        FrameResolution(W, H),
        CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "smoke",
    )
    n = N_WARMUP + N_TIMED
    seq = SyntheticSequence(camera=camera, num_frames=n, radius=0.12, max_angle=0.12)
    frames = [
        tuple(torch.from_numpy(x).cuda() for x in seq.frame(i)) for i in range(n)
    ]
    cfg = EngineConfig(**HEADLINE)
    eng = Engine(camera, cfg, device="cuda")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    gram.LAUNCHES = 0  # count only the main path's launches from here
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
    launches = gram.LAUNCHES
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
    return dict(launches=launches, engine=eng, frames=frames)


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


def main() -> int:
    phase_device()
    k1 = phase_gram()
    slam = phase_slam()
    phase_profile(slam["engine"], slam["frames"])
    k_ms, p_ms = k1["times"][GRAM_SHAPES[0]]
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "densemonoslam_tpu_torch/csrc/gram.cu",
        "replaces": "densemonoslam_tpu/ops/pallas/gram.py:66",
        "launches": slam["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
