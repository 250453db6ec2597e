"""Host syncs and wall time of the tracking calls that still run op by op
on the card, outside the step's graph: `odometry.track` as the local loop
check calls it (`loops.try_local_loop`: identity start, no SO3 pre-align)
and a whole relocalisation attempt (`loops.verify_recovery`: a render of
the map, the SO3 pre-align, `track`, one read of the gates), on the 640x480
synthetic orbit at `chip_smoke.py`'s headline configuration (1<<20 rows, 4
levels, row stride 2, NID keyframing).

    python3 tools/track_reads.py [--root DIR] [--calls 20]

A map is built from 8 frames through the engine; then each form is called
`--calls` times, each call synchronised at both ends, and once more per
call under CUDA's sync-debug mode.  Prints the median, lowest and highest
wall ms a call and the host syncs a call, by source line, as one JSON line.
`--root` imports the port from another checkout (an older commit unpacked
with `git archive`), so that two commits can be compared on one card in one
call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

HEADLINE = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=True,
    nid_threshold=0.85, pyramid_levels=4, track_row_stride=2, open_loop=True,
)
MAP_FRAMES = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout to import the port from")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("track_reads needs a CUDA card", file=sys.stderr)
        return 1
    from densemonoslam_tpu_torch import loops
    from densemonoslam_tpu_torch.config import (
        CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
    )
    from densemonoslam_tpu_torch.engine import Engine
    from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
    from densemonoslam_tpu_torch.tracking import odometry

    W, H = 640, 480
    camera = CameraConfig(
        FrameResolution(W, H), CameraIntrinsics(528.0, 528.0, W / 2 - 0.5, H / 2 - 0.5),
        "track_reads")
    intr = camera.intrinsics
    cfg = EngineConfig(**HEADLINE)
    seq = SyntheticSequence(camera=camera, num_frames=MAP_FRAMES + 1, radius=0.12,
                            max_angle=0.12)
    frames = [tuple(torch.from_numpy(x).cuda() for x in seq.frame(i))
              for i in range(MAP_FRAMES + 1)]
    eng = Engine(camera, cfg)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(MAP_FRAMES):
        eng.process_frame("cam0", *frames[i], float(i))
    torch.cuda.synchronize()
    be = eng.backend_of("cam0")

    def pyramid(i):
        rgb, depth = frames[i]
        return odometry.build_frame_pyramid(rgb, depth.to(torch.float32) / cfg.depth_factor,
                                            intr, cfg.pyramid_levels)

    model = odometry.model_pyramid_from_frame(pyramid(MAP_FRAMES - 1))
    live = pyramid(MAP_FRAMES)
    eye = torch.eye(4, dtype=torch.float32, device="cuda")
    recovery = torch.from_numpy(seq.gt_pose(MAP_FRAMES).astype(np.float32)).cuda()

    def loop_track():
        odometry.track(model, live, eye, intr, iterations=cfg.iterations_for_levels(),
                       icp_weight=cfg.icp_weight, use_so3=False)

    def relocalise():
        loops.verify_recovery(live, recovery, be.map_data, be.map_count, camera, cfg)

    out = {"root": root}
    for name, fn in (("loop check track", loop_track), ("relocalisation attempt", relocalise)):
        fn()  # first call: kernel builds, cuBLAS and cuSOLVER handles
        wall = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(args.calls):
                    fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))
        out[name] = dict(
            wall_ms_median=statistics.median(wall), wall_ms_min=min(wall),
            wall_ms_max=max(wall), syncs_per_call=sum(sites.values()) / args.calls,
            sites={k: v / args.calls for k, v in sites.most_common()},
        )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
