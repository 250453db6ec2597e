"""Headline benchmark of the PyTorch port: dense SLAM frames/s on one card,
multi-metric (the twin of `bench.py`).

    python3 torch_bench.py [--platform cuda|cpu]

Prints ONE JSON line with `bench.py`'s keys: the headline is open-loop
640x480 fps (`vs_baseline` = fps / 30, the reference's real-time gate), and
`extra` carries the same matrix as `bench.py`:

- `closed_loop`: the same configuration with loop closure at its cadence
  over a 40-frame revisit lap (ferns, local loops through the deformation
  graph, kernel K2), with the closures of the timed frames and the wall ms
  per closure;
- `reloc_fps` / `reloc_overhead_pct`: relocalisation mode on;
- `kitti_fps_1024x320`: the dense path at the KITTI frame size;
- `default_cfg_fps`: the default configuration (3 levels, row stride 1);
- `fps_at_32M_capacity`: a 1<<25-row map (2.15 GB), against the windowed
  design's claim that frame cost does not depend on capacity;
- `mono_street_kitti`: the monocular hybrid stack over the 520-frame
  street lap (depth CNN, sparse tracking with local BA, hybrid loops);
- `collab`: the collaborative step on 1 and 8 gloo ranks, each a process of
  its own, on the CPU (the caller's choice, stated as `"platform": "cpu"`:
  one card cannot hold eight ranks, and the efficiency is a ratio).

Every leg runs on the card unless `--platform cpu` says otherwise; the
script fails if CUDA is missing or any leg raises.  Earlier lines give the
card's name and power limit and each leg's peak device memory.  The
environment's `BENCH_FRAMES` (30) and `BENCH_STREET_FRAMES` (520) set the
frame counts, as for `bench.py`.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

BASELINE_FPS = 30.0
COLLAB_TIMEOUT_S = 900.0  # per rank count


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=2)
def _orbit_frames(camera, n_orbit: int, radius: float, max_angle: float) -> tuple:
    """The orbit's (rgb, depth) frames on the host, rendered once for every
    leg that drives the same orbit (set-up, outside the timed frames)."""
    from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(camera=camera, num_frames=n_orbit, radius=radius,
                            max_angle=max_angle)
    return tuple(seq.frame(i) for i in range(n_orbit))


def _run_slam(W, H, n_frames, warmup, cfg_kw, intr=None, lap=0,
              base_cfg=None, device="cuda"):
    """Run one benchmark leg.  `lap` > 0 replays a `lap`-frame orbit
    repeatedly (frame i = orbit frame i % lap) so revisits land in the
    INACTIVE map and the loop-closure machinery actually fires; returns
    (fps, ate_mm, engine, loops_closed_in_timed_region, ms_per_closure)."""
    from densemonoslam_tpu_torch import loops as loopsmod
    from densemonoslam_tpu_torch.config import (
        CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
    )
    from densemonoslam_tpu_torch.engine import Engine
    from densemonoslam_tpu_torch.eval import ate_rmse
    from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence

    camera = CameraConfig(
        FrameResolution(W, H),
        intr or CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480,
                                 W / 2 - 0.5, H / 2 - 0.5),
        "bench",
    )
    n_orbit = lap if lap > 0 else n_frames + warmup
    radius = 0.35 if lap > 0 else 0.12
    max_angle = 0.12 if lap == 0 else 0.3
    seq = SyntheticSequence(
        camera=camera, num_frames=n_orbit, radius=radius, max_angle=max_angle,
    )
    frames = _orbit_frames(camera, n_orbit, radius, max_angle)
    base = dict(
        max_surfels=1 << 20,
        depth_cutoff=8.0,
        depth_factor=1.0,
        nid_keyframing=True,
        nid_threshold=0.85,
        pyramid_levels=4,
        track_row_stride=2,
    )
    if base_cfg:
        base.update(base_cfg)
    cfg = EngineConfig(**{**base, **cfg_kw})
    eng = Engine(camera, cfg, device=device)
    eng.frontend("cam0")
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    frames = [
        (torch.from_numpy(r).to(device), torch.from_numpy(d).to(device))
        for r, d in frames
    ]
    _sync(device)
    for i in range(warmup):
        rgb, depth = frames[i % n_orbit]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
    _sync(device)
    loops_pre = eng.frontends["cam0"].loops_closed
    # time every local-loop invocation inside the timed region: the engine
    # calls it through the module, so the patched attribute is the one called
    loop_s = [0.0, 0]
    orig_try = loopsmod.try_local_loop

    def timed_try(*a, **k):
        t = time.perf_counter()
        out = orig_try(*a, **k)
        loop_s[0] += time.perf_counter() - t
        loop_s[1] += 1
        return out

    loopsmod.try_local_loop = timed_try
    try:
        _sync(device)
        t0 = time.perf_counter()
        for i in range(warmup, warmup + n_frames):
            rgb, depth = frames[i % n_orbit]
            eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        _sync(device)
        fps = n_frames / (time.perf_counter() - t0)
    finally:
        loopsmod.try_local_loop = orig_try
    loops_timed = eng.frontends["cam0"].loops_closed - loops_pre
    ms_per_closure = (
        1e3 * loop_s[0] / loops_timed if loops_timed else 0.0
    )
    est = [p for _, p in eng.frontends["cam0"].trajectory]
    gt = [seq.gt_pose(i % n_orbit) for i in range(len(est))]
    return fps, ate_rmse(est, gt) * 1000.0, eng, loops_timed, ms_per_closure


_STREET = None  # a render worker's sequence


def _street_worker_init(n: int) -> None:
    global _STREET
    from densemonoslam_tpu_torch.config import CameraConfig
    from densemonoslam_tpu_torch.io.street import StreetSequence

    _STREET = StreetSequence(camera=CameraConfig.kitti_default(), num_frames=n,
                             exposure_jitter=0.03)


def _street_rgb(i: int) -> np.ndarray:
    return _STREET.frame(i)[0]


def _street_frames(n: int) -> list:
    """The lap's RGB frames in host memory, rendered by a spawned pool (the
    render is set-up, as in `bench.py`, which renders them before timing)."""
    workers = max(min(len(os.sched_getaffinity(0)) - 1, 16), 1)
    with multiprocessing.get_context("spawn").Pool(
            workers, initializer=_street_worker_init, initargs=(n,)) as pool:
        return pool.map(_street_rgb, range(n), chunksize=4)


def _run_mono_street(device="cuda"):
    """Flagship monocular street lap at the KITTI operating point: CNN depth
    prediction -> sparse tracking with local RGB-D BA -> windowed dense
    fusion -> hybrid loop closure over a ~314 m closing lap."""
    from densemonoslam_tpu_torch import loops as loopsmod
    from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
    from densemonoslam_tpu_torch.engine import Engine
    from densemonoslam_tpu_torch.eval import ate_rmse
    from densemonoslam_tpu_torch.io.street import StreetSequence
    from densemonoslam_tpu_torch.models.depthnet import DepthPredictor
    from densemonoslam_tpu_torch.parallel import ba as bamod
    from densemonoslam_tpu_torch.tracking.sparse import SparseTracker

    n = int(os.environ.get("BENCH_STREET_FRAMES", "520"))
    seq = StreetSequence(
        camera=CameraConfig.kitti_default(), num_frames=n,
        exposure_jitter=0.03,
    )
    cfg = EngineConfig(
        max_surfels=1 << 22, depth_cutoff=40.0, max_depth=80.0,
        depth_factor=1.0, depth_gate_rel=0.1, nid_keyframing=True,
        open_loop=True, predict_depth=True, orb_tracking=True,
        hybrid_loops=True, time_delta=200, pyramid_levels=4,
        track_row_stride=2,
    )
    eng = Engine(seq.camera, cfg, device=device)
    eng.frontend("cam0")
    eng.set_depth_predictor(DepthPredictor.pretrained_street(device=device))
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fe.sparse_tracker = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100, device=device,
    )
    fe.sparse_tracker.pose = fe.pose
    frames = _street_frames(n)  # host render pre-paid
    # pre-warm what is otherwise first used mid-sequence: the first-use
    # kernel builds (`ops/cuda_build.py`) and cuDNN's set-up must land
    # outside the timed frames.  The hybrid loop on a copy of the state and
    # lap-scale PGO solves; engine state is untouched.
    warm_state = fe.state.replace(map_data=fe.state.map_data.clone(),
                                  map_count=fe.state.map_count.clone())
    loopsmod.apply_hybrid_loop(
        warm_state, np.eye(4, dtype=np.float32), seq.camera, cfg,
        rel_bank=loopsmod.make_rel_bank(device=device),
    )
    del warm_state
    eye = torch.eye(4, dtype=torch.float32, device=device)
    for kcap in (256, 512):  # kf counts a 520-frame lap plausibly reaches
        bamod.optimise_pose_graph(
            eye.expand(kcap, 4, 4).contiguous(),
            bamod.PoseGraphEdges(
                i=torch.zeros((kcap,), dtype=torch.int64, device=device),
                j=torch.ones((kcap,), dtype=torch.int64, device=device),
                Z=eye.expand(kcap, 4, 4).contiguous(),
                weight=torch.ones((kcap,), dtype=torch.float32, device=device),
            ),
            cg_iters=128,
        )
    _sync(device)
    # warm replay long enough that the BA window shapes (kf 3..6) and the
    # first periodic compaction (tick 64) have all executed once
    warm = 70
    for i in range(warm):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(warm, n):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    _sync(device)
    fps = (n - warm) / (time.perf_counter() - t0)
    est = [p for _, p in fe.trajectory]
    gt = [seq.gt_pose(i) for i in range(len(est))]
    return {
        "fps": round(fps, 2),
        "ate_m": round(float(ate_rmse(est, gt)), 3),
        "hybrid_loops": fe.loops_closed,
        "sparse_loops": fe.sparse_tracker.loops_closed,
        "surfels": int(fe.state.map_count),
        "frames": n,
    }


# one rank of the collaborative measurement: the JAX bench's orbit, config
# and loop, camera c offset by 2c frames, on the CPU with one thread
_COLLAB_RANK = r"""
import json, os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.parallel import collab, multihost

if not multihost.initialize(backend="gloo"):
    raise RuntimeError("no session configured")
rank, n, iters = dist.get_rank(), dist.get_world_size(), %(iters)d
seq = SyntheticSequence(num_frames=24, radius=0.3, max_angle=0.25)
H = seq.camera.resolution.height
W = seq.camera.resolution.width
cfg = EngineConfig(max_surfels=1 << 15, depth_cutoff=8.0, depth_factor=1.0,
                   max_depth=8.0, nid_keyframing=True, open_loop=False)
frames = [seq.frame((i + 2 * rank) %% 24) for i in range(iters + 1)]
frames = [(torch.from_numpy(r), torch.from_numpy(d)) for r, d in frames]
step = collab.make_collab_step(multihost.session_mesh(), seq.camera.intrinsics, H, W, cfg)
state = collab.init_state(cfg.max_surfels, H, W, device="cpu")
state, stats, total = step(state, *frames[0])  # bootstrap
dist.barrier()
t0 = time.perf_counter()
for i in range(iters):
    state, stats, total = step(state, *frames[i + 1])
dist.barrier()
dt = time.perf_counter() - t0
if rank == 0:
    print("RESULT " + json.dumps({"cam_fps": n * iters / dt}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collab_rate(n: int, iters: int, timeout: float, logdir: str) -> float:
    """Camera-frames/s of the collaborative step on `n` gloo ranks, each a
    `python -c` process with its output in a file, under one time limit."""
    code = _COLLAB_RANK % {"repo": REPO, "iters": iters}
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(DMS_COORDINATOR=f"127.0.0.1:{_free_port()}", DMS_NUM_HOSTS=str(n),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    logs = [os.path.join(logdir, f"collab{n}_rank{r}.log") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], stdout=f, stderr=subprocess.STDOUT,
                    env={**env, "DMS_HOST_ID": str(r)}))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [open(path).read() for path in logs]
    bad = [f"rank {r} exited {p.returncode}:\n{outs[r][-2000:]}"
           for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"collab on {n} ranks failed:\n" + "\n".join(bad))
    line = [x for x in outs[0].splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])["cam_fps"]


def _run_collab(ranks=(1, 8), iters: int = 10, timeout: float = COLLAB_TIMEOUT_S) -> dict:
    """Collaborative scaling: camera-frames/s on each rank count, and the
    efficiency of the largest against the smallest."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="torch_bench_collab_") as logdir:
        for n in ranks:
            out[n] = _collab_rate(n, iters, timeout, logdir)
    lo, hi = min(ranks), max(ranks)
    info = {f"cam_fps_{n}": round(out[n], 2) for n in ranks}
    if hi > lo:
        info["scaling_efficiency"] = round(out[hi] * lo / (hi * out[lo]), 3)
    info["platform"] = "cpu"
    return info


def _summary(fps_open, ate_mm, surfels, n_frames, fps_closed, loops_timed, ms_closure,
             fps_default, fps_reloc, fps_kitti, mono_street, fps_32m, collab_info) -> dict:
    """The one JSON object, in `bench.py`'s keys."""
    return {
        "metric": "slam_fps_640x480_1chip",
        "value": round(fps_open, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_open / BASELINE_FPS, 3),
        "extra": {
            "ate_mm": round(ate_mm, 2),
            "surfels": surfels,
            "frames": n_frames,
            "closed_loop": {
                "fps": round(fps_closed, 2),
                "loops_closed": int(loops_timed),
                "ms_per_closure": round(ms_closure, 1),
            },
            "closed_loop_fps": round(fps_closed, 2),
            "default_cfg_fps": round(fps_default, 2),
            "reloc_fps": round(fps_reloc, 2),
            "reloc_overhead_pct": round(
                100.0 * (1.0 - fps_reloc / max(fps_open, 1e-9)), 1
            ),
            "kitti_fps_1024x320": round(fps_kitti, 2),
            "mono_street_kitti": mono_street,
            "fps_at_32M_capacity": round(fps_32m, 2),
            "collab": collab_info,
        },
    }


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help="the device of every leg but collab (default: the card)")
    args = ap.parse_args(argv)
    device = args.platform
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("torch_bench runs on the card and no CUDA device is available: "
                               "pass --platform cpu to run on the CPU")
        print(f"[bench] card (nvidia-smi name, power.limit): {_card_line()}", flush=True)
    n_frames = int(os.environ.get("BENCH_FRAMES", "30"))
    warmup = 4

    def leg(name, fn, *a, **k):
        """Run one leg; print its wall time and peak device memory."""
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB" if on_card
                else "not measured (CPU)")
        print(f"[bench] {name}: {time.perf_counter() - t0:.1f} s, peak device memory {peak}",
              flush=True)
        return out

    # 1) headline: open-loop 640x480
    fps_open, ate_mm, eng, _, _ = leg(
        "open loop", _run_slam, 640, 480, n_frames, warmup, dict(open_loop=True),
        device=device)
    surfels = eng.surfel_count("cam0")
    del eng
    # 2) closed loop over a revisit lap: real closures inside the timed frames
    fps_closed, _, _, loops_timed, ms_closure = leg(
        "closed loop", _run_slam, 640, 480, 60, 45,
        dict(open_loop=False, loop_check_interval=8, time_delta=30,
             deform_graph_sample_rate=2000, max_deform_nodes=256,
             loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02),
        lap=40, device=device,
    )
    # 3) relocalisation mode
    fps_reloc, _, _, _, _ = leg(
        "relocalisation", _run_slam, 640, 480, n_frames, warmup,
        dict(open_loop=True, relocalisation=True), device=device)
    # 4) KITTI operating point 1024x320
    from densemonoslam_tpu_torch.config import CameraIntrinsics

    fps_kitti, _, _, _, _ = leg(
        "1024x320", _run_slam, 1024, 320, n_frames, warmup, dict(open_loop=True),
        intr=CameraIntrinsics(707.09, 707.09, 601.89, 183.11), device=device,
    )
    # 4b) the default configuration (pyramid_levels=3, row_stride=1)
    fps_default, _, _, _, _ = leg(
        "default config", _run_slam, 640, 480, n_frames, warmup, dict(open_loop=True),
        base_cfg=dict(pyramid_levels=3, track_row_stride=1), device=device,
    )
    # 4d) reference capacity: 1<<25 rows (2.15 GB at 64 B/row)
    fps_32m, _, _, _, _ = leg(
        "1<<25 capacity", _run_slam, 640, 480, max(n_frames // 2, 10), warmup,
        dict(open_loop=True, max_surfels=1 << 25), device=device,
    )
    # 4c) flagship monocular street lap
    mono_street = leg("mono street", _run_mono_street, device=device)
    # 5) collaborative scaling: gloo ranks on the CPU
    collab_info = leg("collab (CPU ranks)", _run_collab)

    print(json.dumps(_summary(
        fps_open, ate_mm, surfels, n_frames, fps_closed, loops_timed, ms_closure,
        fps_default, fps_reloc, fps_kitti, mono_street, fps_32m, collab_info,
    )))


if __name__ == "__main__":
    main()
