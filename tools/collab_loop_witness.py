"""Does the collaborative full pipeline close its intra-map loops at 640x480?

    python3 tools/collab_loop_witness.py --package jax --levels 3
    python3 tools/collab_loop_witness.py --package torch --levels 5 --stride 2
    python3 tools/collab_loop_witness.py --package jax --levels 5 --stride 2 \
        --track-at 28 --camera 1 --state model28.npz
    python3 tools/collab_loop_witness.py --package torch --levels 5 --stride 2 \
        --track-at 28 --camera 1 --state model28.npz

Runs the body of `tests/test_intermap_collab.py`'s
`test_collab_full_pipeline_closes_intra_map_loops` (two cameras, 6 orbit
frames apart, laps of 30 frames, 52 frames, a local-loop round every 4th
frame from frame 30) on the CPU at 640x480 with the bench's intrinsics
(528 * W / 640) and 1<<20-row maps, as `chip_smoke.py`'s collaborative leg
runs it on the card, at the tracker's pyramid depth and finest-level row
stride given on the command line.

`--package jax` runs the JAX package's `parallel.collab` over two virtual
CPU devices; `--package torch` runs the port's per-camera step and
`loops.try_local_loop`, which is what each rank of the port's
`parallel.collab` runs before it gathers.  It prints each round's
(closed, inactive fraction, inlier fraction, ICP error, constraint error)
per camera and ends with one JSON line of the loops closed per camera.

With `--track-at F --camera C` it instead probes one frame's tracking:
the JAX run steps camera C alone (as its collab step does) through frame
F - 1, writes the tracking model it holds then (the stored prediction and
`model_rel`) to `--state`, and tracks frame F against it with the JAX
package's `odometry.track` jitted and op by op (`jax.disable_jit`); the
torch run reads that file and tracks frame F with the port's
`odometry.track`.  Each prints whether the guard failed the solve, the
translation of A, and the ICP inliers and error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAP, TOTAL, OFF = 30, 52, 6
W, H = 640, 480
CONFIG = dict(
    max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0, max_depth=8.0, nid_keyframing=True,
    nid_threshold=0.85, open_loop=False, time_delta=30, deform_graph_sample_rate=2000,
    max_deform_nodes=256, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
)


def _frames(config_mod, synthetic_mod):
    camera = config_mod.CameraConfig(
        config_mod.FrameResolution(W, H),
        config_mod.CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "witness",
    )
    seq = synthetic_mod.SyntheticSequence(camera=camera, num_frames=40, radius=0.3, max_angle=0.25)
    return camera, [seq.frame(i) for i in range(LAP)]


def _frame_index(camera_idx: int, f: int) -> int:
    return (f + camera_idx * OFF) % LAP


def run_jax(extra: dict) -> list:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from densemonoslam_tpu import config as cfgmod
    from densemonoslam_tpu.io import synthetic
    from densemonoslam_tpu.parallel import collab
    from densemonoslam_tpu.parallel.mesh import make_mesh

    camera, frames = _frames(cfgmod, synthetic)
    cfg = cfgmod.EngineConfig(**CONFIG, **extra)
    mesh = make_mesh(n_cams=2, n_map=1, devices=jax.devices()[:2])
    step = collab.make_collab_step(mesh, camera.intrinsics, H, W, cfg)
    loop_round = collab.make_collab_local_loop(mesh, camera.intrinsics, H, W, cfg)
    state = collab.init_state(2, cfg.max_surfels, H, W)
    banks = collab.init_rel_banks(2)
    closed = np.zeros(2, np.int64)
    for i in range(TOTAL):
        rgb = np.stack([frames[_frame_index(c, i)][0] for c in range(2)])
        dep = np.stack([frames[_frame_index(c, i)][1] for c in range(2)])
        state, _, _ = step(state, jnp.asarray(rgb), jnp.asarray(dep))
        if i >= LAP and i % 4 == 0:
            state, banks, infos = loop_round(state, banks)
            infos = np.asarray(infos)
            closed += (infos[:, 0] > 0).astype(np.int64)
            print(f"frame {i}: {infos.round(6).tolist()}", flush=True)
    print(f"map rows per camera {np.asarray(state.map_count).tolist()}", flush=True)
    return closed.tolist()


def run_torch(extra: dict) -> list:
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    from densemonoslam_tpu_torch import config as cfgmod
    from densemonoslam_tpu_torch import loops
    from densemonoslam_tpu_torch import step as stepmod
    from densemonoslam_tpu_torch.io import synthetic

    camera, frames = _frames(cfgmod, synthetic)
    cfg = cfgmod.EngineConfig(**CONFIG, **extra)
    step = stepmod.make_step(camera.intrinsics, H, W, cfg)
    states = [stepmod.init_state(cfg.max_surfels, H, W, device="cpu") for _ in range(2)]
    banks = [loops.make_rel_bank(device="cpu") for _ in range(2)]
    eye = torch.eye(4)
    closed = np.zeros(2, np.int64)
    for i in range(TOTAL):
        infos = []
        for c in range(2):
            rgb, dep = frames[_frame_index(c, i)]
            states[c], _ = step(states[c], torch.from_numpy(rgb), torch.from_numpy(dep), eye,
                                False, 1.0, 0.0)
            if i >= LAP and i % 4 == 0:
                states[c], info, _, banks[c] = loops.try_local_loop(states[c], camera, cfg,
                                                                    rel_bank=banks[c])
                infos.append([float(info.closed), info.inactive_frac, info.inlier_frac,
                              info.icp_error, info.cons_error])
                closed[c] += int(info.closed)
        if infos:
            print(f"frame {i}: {np.round(infos, 6).tolist()}", flush=True)
    print(f"map rows per camera {[int(s.map_count) for s in states]}", flush=True)
    return closed.tolist()


def _print_track(label: str, failed, A, inliers, error) -> None:
    print(f"{label}: failed {bool(failed)}, translation {np.asarray(A)[:3, 3].round(6).tolist()}, "
          f"ICP inliers {float(inliers):.0f}, ICP error {float(error):.6g}", flush=True)


def probe_jax(extra: dict, camera_idx: int, frame: int, path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from densemonoslam_tpu import config as cfgmod
    from densemonoslam_tpu import step as stepmod
    from densemonoslam_tpu.io import synthetic
    from densemonoslam_tpu.ops import preprocess
    from densemonoslam_tpu.tracking import odometry

    camera, frames = _frames(cfgmod, synthetic)
    cfg = cfgmod.EngineConfig(**CONFIG, **extra)
    step = jax.jit(stepmod.make_step(camera.intrinsics, H, W, cfg))
    state = stepmod.init_state(cfg.max_surfels, H, W)
    eye, no = jnp.eye(4, dtype=jnp.float32), jnp.asarray(False)
    for f in range(frame):
        rgb, dep = frames[_frame_index(camera_idx, f)]
        state, _ = step(state, jnp.asarray(rgb), jnp.asarray(dep), eye, no, jnp.float32(1.0),
                        jnp.float32(0.0))
    model = {k: np.asarray(getattr(state, k))
             for k in ("pred_intensity", "pred_vmap", "pred_nmap", "model_rel")}
    np.savez(path, **model)
    rgb, dep = frames[_frame_index(camera_idx, frame)]
    depth = preprocess.bilateral_filter_depth(preprocess.metricise_depth(
        jnp.asarray(dep), cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff)))
    levels = cfg.pyramid_levels

    def track():
        fp = odometry.build_frame_pyramid(jnp.asarray(rgb), depth, camera.intrinsics, levels)
        mp = odometry.build_model_pyramid(*(jnp.asarray(model[k]) for k in (
            "pred_intensity", "pred_vmap", "pred_nmap")), levels)
        return odometry.track(mp, fp, jnp.asarray(model["model_rel"]), camera.intrinsics,
                              iterations=cfg.iterations_for_levels(),
                              row_stride=cfg.track_row_stride)

    r = track()
    _print_track("jax, jitted", r.failed, r.A, r.icp_inliers, r.icp_error)
    with jax.disable_jit():
        r = track()
    _print_track("jax, op by op", r.failed, r.A, r.icp_inliers, r.icp_error)


def probe_torch(extra: dict, camera_idx: int, frame: int, path: str) -> None:
    import torch

    from densemonoslam_tpu_torch import config as cfgmod
    from densemonoslam_tpu_torch.io import synthetic
    from densemonoslam_tpu_torch.ops import preprocess
    from densemonoslam_tpu_torch.tracking import odometry

    camera, frames = _frames(cfgmod, synthetic)
    cfg = cfgmod.EngineConfig(**CONFIG, **extra)
    model = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    rgb, dep = frames[_frame_index(camera_idx, frame)]
    depth = preprocess.bilateral_filter_depth(preprocess.metricise_depth(
        torch.from_numpy(dep), cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff)))
    levels = cfg.pyramid_levels
    fp = odometry.build_frame_pyramid(torch.from_numpy(rgb), depth, camera.intrinsics, levels)
    mp = odometry.build_model_pyramid(model["pred_intensity"], model["pred_vmap"],
                                      model["pred_nmap"], levels)
    r = odometry.track(mp, fp, model["model_rel"], camera.intrinsics,
                       iterations=cfg.iterations_for_levels(), row_stride=cfg.track_row_stride)
    _print_track("torch", r.failed, r.A, r.icp_inliers, r.icp_error)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--levels", type=int, default=3, help="pyramid_levels (the config's default: 3)")
    ap.add_argument("--stride", type=int, default=1, help="track_row_stride (the default: 1)")
    ap.add_argument("--track-at", type=int, help="probe the tracking of this frame instead")
    ap.add_argument("--camera", type=int, default=0, help="the probed camera (0 or 1)")
    ap.add_argument("--state", default="tracking_model.npz",
                    help="the probed frame's tracking model: written by jax, read by torch")
    args = ap.parse_args()
    extra = dict(pyramid_levels=args.levels, track_row_stride=args.stride)
    if args.track_at is not None:
        probe = probe_jax if args.package == "jax" else probe_torch
        probe(extra, args.camera, args.track_at, args.state)
        return 0
    t0 = time.perf_counter()
    closed = (run_jax if args.package == "jax" else run_torch)(extra)
    print(json.dumps(dict(package=args.package, **extra, loops_closed=closed,
                          seconds=round(time.perf_counter() - t0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
