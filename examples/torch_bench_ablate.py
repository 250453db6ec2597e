"""End-to-end ablation sweep of the per-frame step on the PyTorch port (the
twin of `examples/bench_ablate.py`).

Measures synchronised frames/s for config variants to attribute the frame
budget.  `python examples/torch_bench_ablate.py [variant ...]` (default:
all) runs on the card; `--platform cpu` runs on the CPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from densemonoslam_tpu_torch.config import (
    CameraConfig,
    CameraIntrinsics,
    EngineConfig,
    FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence

W, H = 640, 480
camera = CameraConfig(
    FrameResolution(W, H),
    CameraIntrinsics(528.0, 528.0, W / 2 - 0.5, H / 2 - 0.5),
    "bench",
)

BASE = dict(
    max_surfels=1 << 20,
    depth_cutoff=8.0,
    depth_factor=1.0,
    nid_keyframing=True,
    nid_threshold=0.85,
    pyramid_levels=4,
    track_row_stride=2,
    open_loop=True,
)

VARIANTS = {
    "base": {},
    "cap_256k": dict(max_surfels=1 << 18),
    "cap_512k": dict(max_surfels=1 << 19),
    "no_nid": dict(nid_keyframing=False),
    "levels3": dict(pyramid_levels=3),
    "stride4": dict(track_row_stride=4),
    "fast_odom": dict(fast_odom=True),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(name, overrides, n_frames=24, warmup=4, device="cuda", cam=camera):
    """Time `n_frames` frames after `warmup` of the orbit on one variant;
    prints and returns frames/s."""
    cfg = EngineConfig(**{**BASE, **overrides})
    seq = SyntheticSequence(
        camera=cam, num_frames=n_frames + warmup, radius=0.12, max_angle=0.12
    )
    frames = [
        (torch.from_numpy(r).to(device), torch.from_numpy(d).to(device))
        for r, d in (seq.frame(i) for i in range(n_frames + warmup))
    ]
    _sync(device)
    eng = Engine(cam, cfg, device=device)
    eng.frontend("cam0")
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    for i in range(warmup):
        rgb, depth = frames[i]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(warmup, warmup + n_frames):
        rgb, depth = frames[i]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{name:12s} {n_frames / dt:7.2f} fps   {dt / n_frames * 1000:7.2f} ms/frame")
    return n_frames / dt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")
    for name in args.variants or list(VARIANTS):
        run(name, VARIANTS[name], device=args.platform)


if __name__ == "__main__":
    main()
