"""Run the PyTorch port on the synthetic sequence and report ATE + frames/s
(the twin of `examples/run_synthetic.py`).

Usage:
    python examples/torch_run_synthetic.py [--frames N] [--platform cuda|cpu]
        [--odometry-only] [--out DIR]

`--odometry-only` tracks each frame against the previous one (dense
frame-to-frame odometry through `model_pyramid_from_frame`, no map).
Without it the full engine runs (always fuse, a 1<<18-surfel map) and
`--out` writes the trajectory (`.freiburg`), the map (`.ply`), the stage
timings and the session stats.  The exit code is 0 iff the ATE is under
20 mm.

Everything runs on the card unless `--platform cpu` is given.  The frames
are rendered on the host before the clock starts; frames/s counts frames
2..N-1, with the device synchronised at both ends.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from densemonoslam_tpu_torch.config import EngineConfig  # noqa: E402
from densemonoslam_tpu_torch.engine import Engine  # noqa: E402
from densemonoslam_tpu_torch.eval import ate_rmse  # noqa: E402
from densemonoslam_tpu_torch.io import SyntheticSequence  # noqa: E402
from densemonoslam_tpu_torch.tracking import odometry  # noqa: E402
from densemonoslam_tpu_torch.utils.timer import Stopwatch  # noqa: E402

ATE_BOUND_M = 0.02  # the exit code's bound
LEVELS = 3


def sequence(frames: int) -> SyntheticSequence:
    return SyntheticSequence(num_frames=frames, radius=0.35, max_angle=0.3)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_odometry(seq: SyntheticSequence, frames: int, device="cuda",
                 levels: int = LEVELS) -> dict:
    """Frame-to-frame tracking of the first `frames` frames: each frame's
    `levels`-level pyramid is tracked against the previous frame's from the
    identity, and the relative poses are chained from the true first pose.
    Returns the poses, ATE (m), frames/s, tracking failures and the stage
    timer."""
    if frames < 3:
        raise ValueError("frames/s needs at least 3 frames")
    intr = seq.camera.intrinsics
    host = [seq.frame(i) for i in range(frames)]
    eye = torch.eye(4, dtype=torch.float32, device=device)
    sw = Stopwatch()
    poses = [seq.gt_pose(0)]
    failures = 0
    prev = None
    t_start = None
    for i, (rgb, depth) in enumerate(host):
        t0 = sw.tick("pyramid")
        cur = odometry.build_frame_pyramid(
            torch.as_tensor(rgb, device=device), torch.as_tensor(depth, device=device),
            intr, levels,
        )
        sw.tock("pyramid", t0, block=cur.vmap[0])
        if prev is not None:
            t0 = sw.tick("track")
            res = odometry.track(odometry.model_pyramid_from_frame(prev), cur, eye, intr)
            out = torch.cat([res.A.reshape(-1), res.failed.reshape(1).float()]).cpu().numpy()
            sw.tock("track", t0)
            failures += int(out[16] > 0)
            poses.append(poses[-1] @ out[:16].reshape(4, 4).astype(np.float64))
        prev = cur
        if i == 1:
            _sync(device)
            t_start = time.perf_counter()
    _sync(device)
    fps = (frames - 2) / (time.perf_counter() - t_start)
    ate = ate_rmse(poses, [seq.gt_pose(i) for i in range(frames)])
    return dict(poses=poses, ate=ate, fps=fps, failures=failures, timer=sw)


def engine_config() -> EngineConfig:
    # always fuse (the reference's --nkf)
    return EngineConfig(max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0,
                        nid_keyframing=False)


def run_slam(seq: SyntheticSequence, frames: int, device="cuda", out=None) -> dict:
    """The full engine on the first `frames` frames from the true first
    pose; with `out`, the four exports.  Returns ATE (m), frames/s, frames
    whose tracking failed, surfels and the engine."""
    if frames < 3:
        raise ValueError("frames/s needs at least 3 frames")
    host = [seq.frame(i) for i in range(frames)]
    eng = Engine(seq.camera, engine_config(), device=device)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    failed = []
    t_start = None
    for i, (rgb, depth) in enumerate(host):
        info = eng.process_frame("cam0", rgb, depth, float(i))
        if info["tracking_ok"] != 1.0:
            failed.append(i)
            print(f"frame {i}: TRACKING FAILED")
        if i == 1:
            _sync(device)
            t_start = time.perf_counter()
    _sync(device)
    fps = (frames - 2) / (time.perf_counter() - t_start)
    est = [p for _, p in fe.trajectory]
    ate = ate_rmse(est, [seq.gt_pose(i) for i in range(frames)])
    res = dict(ate=ate, fps=fps, failed=failed, surfels=eng.surfel_count("cam0"), engine=eng)
    if out:
        os.makedirs(out, exist_ok=True)
        eng.save_trajectory("cam0", os.path.join(out, "synthetic.freiburg"))
        res["ply_surfels"] = eng.save_ply("cam0", os.path.join(out, "map.ply"),
                                          stable_only=False)
        eng.save_times(os.path.join(out, "timings.csv"))
        eng.save_stats("cam0", os.path.join(out, "run.stats"))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--odometry-only", action="store_true",
                    help="frame-to-frame tracking, no map")
    ap.add_argument("--out", default=None, help="directory for .freiburg/.ply exports")
    args = ap.parse_args(argv)
    seq = sequence(args.frames)

    if args.odometry_only:
        res = run_odometry(seq, args.frames, args.platform)
        print(f"[odometry] frames: {args.frames}  ATE: {res['ate'] * 1000:.2f} mm  "
              f"fps: {res['fps']:.1f}  failures: {res['failures']}")
        print("stage means (ms):", {k: round(v, 2) for k, v in res["timer"].summary().items()})
        return 0 if res["ate"] < ATE_BOUND_M else 1

    res = run_slam(seq, args.frames, args.platform, args.out)
    eng = res["engine"]
    print(f"[slam] frames: {args.frames}  ATE: {res['ate'] * 1000:.2f} mm  "
          f"fps: {res['fps']:.1f}  surfels: {res['surfels']}")
    print("stage means (ms):", {k: round(v, 2) for k, v in eng.timer.summary().items()})
    if args.out:
        print(f"wrote {args.out}/: trajectory, map.ply ({res['ply_surfels']} surfels), "
              "timings, stats")
    return 0 if res["ate"] < ATE_BOUND_M else 1


if __name__ == "__main__":
    sys.exit(main())
