"""Does frame-to-frame odometry track the 640x480 orbit at a given depth?

    python3 tools/odometry_levels_witness.py --package jax --levels 4
    python3 tools/odometry_levels_witness.py --package torch --levels 4

Runs `examples/run_synthetic.py --odometry-only` (or its port's twin) on the
CPU on the orbit of `chip_smoke.py`'s odometry leg: 640x480 with the bench's
intrinsics (528 * W / 640), `SyntheticSequence(radius=0.35, max_angle=0.3)`,
30 frames; each frame's pyramid, `--levels` deep, is tracked against the
previous frame's from the identity and the relative poses are chained from
the true first pose.  `--package jax` uses the JAX package's jitted
`odometry.track`, `--package torch` the port's.

It prints each tracked frame's guard flag and the error of its relative
translation against the truth (mm), and ends with one JSON line: the
package, the levels, ATE (mm), the frames whose guard failed and the
frames whose relative translation is off by more than 5 mm.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H = 640, 480
FRAMES = 30
OFF_MM = 5.0  # a relative translation off by more than this is reported


def _sequence(config_mod, synthetic_mod):
    camera = config_mod.CameraConfig(
        config_mod.FrameResolution(W, H),
        config_mod.CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "witness",
    )
    return synthetic_mod.SyntheticSequence(camera=camera, num_frames=FRAMES, radius=0.35,
                                           max_angle=0.3)


def track_jax(levels: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from densemonoslam_tpu import config as cfgmod
    from densemonoslam_tpu.io import synthetic
    from densemonoslam_tpu.tracking import odometry

    seq = _sequence(cfgmod, synthetic)
    intr = seq.camera.intrinsics
    eye = jnp.eye(4, dtype=jnp.float32)
    prev, out = None, []
    for i in range(FRAMES):
        rgb, depth = seq.frame(i)
        cur = odometry.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(depth), intr, levels)
        if prev is not None:
            res = odometry.track(odometry.model_pyramid_from_frame(prev), cur, eye, intr)
            out.append((np.asarray(res.A, np.float64), bool(res.failed)))
        prev = cur
    return seq, out


def track_torch(levels: int):
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    from densemonoslam_tpu_torch import config as cfgmod
    from densemonoslam_tpu_torch.io import synthetic
    from densemonoslam_tpu_torch.tracking import odometry

    seq = _sequence(cfgmod, synthetic)
    intr = seq.camera.intrinsics
    eye = torch.eye(4)
    prev, out = None, []
    for i in range(FRAMES):
        rgb, depth = seq.frame(i)
        cur = odometry.build_frame_pyramid(torch.from_numpy(rgb), torch.from_numpy(depth), intr,
                                           levels)
        if prev is not None:
            res = odometry.track(odometry.model_pyramid_from_frame(prev), cur, eye, intr)
            out.append((res.A.numpy().astype(np.float64), bool(res.failed)))
        prev = cur
    return seq, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--levels", type=int, default=4)
    args = ap.parse_args()
    seq, out = (track_jax if args.package == "jax" else track_torch)(args.levels)
    if args.package == "jax":
        from densemonoslam_tpu.eval import ate_rmse
    else:
        from densemonoslam_tpu_torch.eval import ate_rmse
    gt = [seq.gt_pose(i) for i in range(FRAMES)]
    poses, failed, off = [gt[0]], [], []
    for i, (A, bad) in enumerate(out, start=1):
        poses.append(poses[-1] @ A)
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        err_mm = 1e3 * float(np.linalg.norm(A[:3, 3] - rel[:3, 3]))
        print(f"frame {i}: failed {bad}, relative translation off by {err_mm:.3f} mm", flush=True)
        if bad:
            failed.append(i)
        if err_mm > OFF_MM:
            off.append(i)
    ate_mm = 1e3 * ate_rmse(poses, gt)
    print(json.dumps(dict(package=args.package, levels=args.levels, ate_mm=ate_mm,
                          failed=failed, off_by_over_5mm=off)))


if __name__ == "__main__":
    main()
