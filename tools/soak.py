"""Long-sequence soak of the PyTorch port: `tests/test_soak.py`'s
configuration and bounds, on the card.

    python3 tools/soak.py                      # 1000 frames on the GPU
    python3 tools/soak.py --device cpu --frames 100

1000 frames of repeated 40-frame laps of the 160x120 synthetic orbit through
the whole engine (tracking, fusion, NID keyframing, the active window and
compaction, loop checks every 16 frames), with the JAX test's bounds:

- the map stays below 0.8 x its 1<<18 rows, and below twice its size at
  frame 300 (it plateaus rather than growing with the frames);
- the last three 100-frame batches take less than twice the early ones
  (batches 2-4);
- ATE against the orbit's truth stays below 30 mm.

Every 100 frames the device is synchronised and the batch's wall time and
the map's size are taken.  With fewer than 1000 frames the bounds that need
them are reported as not checked.  The last line is a JSON summary; the exit
code is 1 if a checked bound fails.  On the GPU the card's name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from densemonoslam_tpu_torch.config import EngineConfig  # noqa: E402
from densemonoslam_tpu_torch.engine import Engine  # noqa: E402
from densemonoslam_tpu_torch.eval import ate_rmse  # noqa: E402
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from densemonoslam_tpu_torch.ops import deform, gram  # noqa: E402

LAP = 40  # frames per orbit lap; frame i revisits frame i % LAP
BATCH = 100
# tests/test_soak.py:28-41
CFG = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=True,
    nid_threshold=0.80, time_delta=60, loop_check_interval=16, deform_graph_sample_rate=600,
    max_deform_nodes=128, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
    confidence_threshold=1.0,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0], flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seq = SyntheticSequence(num_frames=LAP, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(**CFG)
    eng = Engine(seq.camera, cfg, device=dev)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    frames = [seq.frame(i) for i in range(LAP)]  # rendered first: host cost out
    gram.LAUNCHES = deform.LAUNCHES = 0
    batch_s, counts = [], []
    sync()
    t_start = t0 = time.perf_counter()
    for i in range(args.frames):
        rgb, depth = frames[i % LAP]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        if (i + 1) % BATCH == 0:
            sync()
            t1 = time.perf_counter()
            batch_s.append(t1 - t0)
            counts.append(int(fe.state.map_count))
            t0 = t1
            print(f"[soak] frames {i + 1 - BATCH}-{i}: {batch_s[-1]:.3f} s, map {counts[-1]} "
                  f"surfels, loops {fe.loops_closed}", flush=True)
    sync()
    total_s = time.perf_counter() - t_start
    rows = torch.stack(fe.stats_log).cpu().numpy()
    est = [p for _, p in fe.trajectory]
    ate = ate_rmse(est, [seq.gt_pose(i % LAP) for i in range(args.frames)])
    checks = {}
    if len(counts) >= 3:
        checks["map < 0.8 x capacity"] = counts[-1] < 0.8 * cfg.max_surfels
        checks["map < 2 x its size at frame 300"] = counts[-1] < 2.0 * counts[2]
    if len(batch_s) >= 7:
        early, late = float(np.mean(batch_s[1:4])), float(np.mean(batch_s[-3:]))
        checks["late batches < 2 x early"] = late < 2.0 * early
    else:
        early = late = None
    if args.frames >= 1000:
        checks["ATE < 30 mm"] = ate < 0.03
    summary = dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        frames=args.frames, total_s=total_s, ms_per_frame=1e3 * total_s / args.frames,
        batch_s=batch_s, counts=counts, early_s=early, late_s=late, ate_mm=1e3 * ate,
        loops=fe.loops_closed, dropped=float(rows[:, 12].sum()), k1_launches=gram.LAUNCHES,
        k2_launches=deform.LAUNCHES, checks=checks,
    )
    print(json.dumps(summary), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
