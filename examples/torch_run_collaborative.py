"""Collaborative multi-camera session on the PyTorch port (the twin of
`examples/run_collaborative.py`): two cameras stream frames over UDP into one
engine, each in its own world frame; their maps merge when the second camera
sees territory the first has mapped, the relative transform found through
ferns and dense ICP.

Usage: python examples/torch_run_collaborative.py [--frames 14]
           [--platform cuda|cpu]

The engine runs on the card unless `--platform cpu` is given.  The receiver
binds a free UDP port on localhost.  The exit code is 0 iff the maps merge.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from densemonoslam_tpu_torch.config import EngineConfig  # noqa: E402
from densemonoslam_tpu_torch.engine import Engine  # noqa: E402
from densemonoslam_tpu_torch.io.stream import (  # noqa: E402
    FrameReceiver, FrameSender, StreamCameraManager,
)
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402

CAMERAS = {"camA": 0, "camB": 6}  # first frame of each sender: camB revisits camA's ground


def engine_config() -> EngineConfig:
    return EngineConfig(
        max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1000.0,
        nid_keyframing=False, loop_check_interval=4, time_delta=500,
        confidence_threshold=1.0,
    )


def run(frames: int = 14, device="cuda") -> dict:
    """Stream `frames` frames from each camera through UDP into one engine.
    Returns the frames processed per camera, the counts when the maps
    merged (None if they did not), the number of maps and the engine."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    rx = FrameReceiver(port=0)  # a free port
    try:
        mgr = StreamCameraManager(rx, depth_factor=1000.0)

        def sender(name: str, start: int) -> None:
            tx = FrameSender(name, port=rx.port)
            try:
                for k in range(frames):
                    rgb, depth = seq.frame(start + k)
                    tx.send(rgb, (depth * 1000).astype(np.uint16), timestamp=start + k)
            finally:
                tx.close()

        threads = [threading.Thread(target=sender, args=item) for item in CAMERAS.items()]
        for t in threads:
            t.start()
        eng = Engine(seq.camera, engine_config(), device=device)
        if not mgr.wait_for_cameras(len(CAMERAS), timeout=30.0):
            raise RuntimeError(f"only {mgr.cameras()} of {list(CAMERAS)} started streaming")
        # each camera starts in its own world frame: the merge must find the
        # relative transform
        eng.frontend("camA").pose = seq.gt_pose(0).astype(np.float32)
        eng.frontend("camB").pose = np.eye(4, dtype=np.float32)
        n = dict.fromkeys(CAMERAS, 0)
        merged_at = None
        while sum(n.values()) < len(CAMERAS) * frames:
            got_any = False
            for cam in CAMERAS:
                got = mgr.get_next(cam, timeout=2.0)
                if got is None:
                    continue
                got_any = True
                rgb, depth_m, ts = got
                eng.process_frame(cam, rgb, depth_m * 1000.0, ts)
                n[cam] += 1
            if merged_at is None and len(eng.maps) == 1:
                merged_at = dict(n)
                print(f"*** maps merged after {merged_at} frames ***")
            if not got_any and not any(t.is_alive() for t in threads):
                break  # every sender is done and frames were lost on the way
        for t in threads:
            t.join(timeout=30.0)
    finally:
        rx.close()
    return dict(frames=n, merged_at=merged_at, maps=len(eng.maps), engine=eng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    res = run(args.frames, args.platform)
    eng = res["engine"]
    print(f"frames: {res['frames']}; maps: {res['maps']}; "
          f"surfels: {eng.surfel_count(eng.frontends['camA'].map_name)}")
    rel = np.linalg.inv(eng.frontends["camA"].pose) @ eng.frontends["camB"].pose
    print("relative pose camA->camB translation:", rel[:3, 3].round(3))
    return 0 if res["merged_at"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
