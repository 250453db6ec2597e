"""Per-stage timing of the per-frame SLAM step of the PyTorch port (the twin
of `examples/profile_stages.py`).

Times each pipeline stage (preprocess, tracking GN through kernel K1, splat
render, fusion, NID) as its own call over realistic 640x480 state, then the
full step, so optimisation effort lands where the frame time goes.  The
stages and FULL_STEP run op by op (`step.make_step`); on the card "full step
(graphed)" is the engine's step, one CUDA graph replayed.  Each row's time
is its synchronised wall time per call; on the card its device time per
call stands beside it: for the op-by-op rows the summed self time of its
kernels, copies and fills under `torch.profiler`
(`examples/torch_xbench.py`), for the graph's row CUDA events around
back-to-back replays, which the host queues faster than the card runs them.

Usage: python examples/torch_profile_stages.py [--width 640 --height 480]
       [--frames 24] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import fusion, keyframe as kfmod
from densemonoslam_tpu_torch.ops import geometry, preprocess, splat
from densemonoslam_tpu_torch.tracking import odometry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_xbench import xbench  # noqa: E402


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, *args, iters=30, warmup=3, device="cuda"):
    """Synchronised wall ms per call over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1000.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    W, H = args.width, args.height
    dev = args.platform
    on_card = dev == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")

    camera = CameraConfig(
        FrameResolution(W, H),
        CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "prof",
    )
    cfg = EngineConfig(
        max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0,
        nid_keyframing=True, pyramid_levels=4, track_row_stride=2,
        open_loop=True,
    )
    seq = SyntheticSequence(camera=camera, num_frames=args.frames, radius=0.12,
                            max_angle=0.12)
    eng = Engine(camera, cfg, device=dev)
    eng.frontend("cam0")
    frames = [
        (torch.from_numpy(r).to(dev), torch.from_numpy(d).to(dev))
        for r, d in (seq.frame(i) for i in range(args.frames))
    ]
    # build up a real mid-sequence state
    for i in range(args.frames):
        eng.process_frame("cam0", *frames[i], float(i), sync=False)
    st = eng.frontends["cam0"].state
    _sync(dev)
    intr = camera.intrinsics
    rgb, depth_raw = frames[-1]
    levels = cfg.pyramid_levels

    # --- stages ---
    def stage_preprocess(rgb, depth_raw):
        depth_track = preprocess.metricise_depth(
            depth_raw, cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff))
        depth_m = torch.where(depth_track <= cfg.depth_cutoff, depth_track, 0.0)
        depth_f = preprocess.bilateral_filter_depth(depth_track)
        vmap_f = geometry.backproject(depth_m, intr)
        nmap_f = geometry.normal_map(vmap_f)
        intensity = preprocess.rgb_to_intensity(rgb)
        pyr = odometry.build_frame_pyramid(rgb, depth_f, intr, levels)
        return depth_m, vmap_f, nmap_f, intensity, pyr

    depth_m, vmap_f, nmap_f, intensity, frame_pyr = stage_preprocess(rgb, depth_raw)

    def stage_model_pyr(pi, pv, pn):
        return odometry.build_model_pyramid(pi, pv, pn, levels)

    model_pyr = stage_model_pyr(st.pred_intensity, st.pred_vmap, st.pred_nmap)

    def stage_track(model_pyr, frame_pyr, A):
        return odometry.track(
            model_pyr, frame_pyr, A, intr,
            iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight,
            row_stride=cfg.track_row_stride)

    stage_track(model_pyr, frame_pyr, st.model_rel)

    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def stage_render(data, count, pose, t):
        return splat.render(data, count, pose, intr, W, H, t,
                            time_delta=cfg.time_delta,
                            mode=splat.MODE_ACTIVE, window=win)

    pred = stage_render(st.map_data, st.map_count, st.pose, st.tick)

    N_cap = st.map_data.shape[0] - 1
    win_n = win if (win > 0 and win < N_cap) else N_cap

    def stage_fuse(data, count, pred, vmap_f, nmap_f, rgb, pose, t):
        win_start = splat.active_window_start(count, N_cap, win_n)
        blk, packed, rank, n_want, matched, culled = fusion.fuse_window(
            splat.window_rows(data, win_start, win_n), win_start, count, pred, vmap_f,
            nmap_f, rgb.to(torch.float32), pose, intr, time=t, sensor=0,
            weight_mult=torch.ones((), dtype=torch.float32, device=data.device),
            clean_depth=depth_m, conf_threshold=cfg.confidence_threshold,
            time_delta=cfg.time_delta, cluster_id=0.0)
        data2, count2, added, dropped = fusion.place_updates(
            data, count, blk, win_start, packed[: H * W], n_want, rank[: H * W])
        return data2, count2

    def stage_nid(kf_pose, kf_int, kf_dep, intensity, vmap_f, pose):
        n_img, n_depth, overlap = kfmod.nid_against_keyframe(
            kfmod.KeyFrame(pose=kf_pose, intensity=kf_int, depth=kf_dep),
            intensity, vmap_f, pose, intr, depth_max=cfg.depth_cutoff,
            bins_img=cfg.nid_bins_img, bins_depth=cfg.nid_bins_depth,
            stride=cfg.nid_stride)
        return kfmod.nid_score(n_img, n_depth, cfg.nid_depth_weight)

    # fusion writes its map in place: it gets a copy, so that the stages
    # after it and the full step see the mid-sequence map
    fuse_data = st.map_data.clone()
    cases = {
        "preprocess": (stage_preprocess, (rgb, depth_raw)),
        "model_pyramid": (stage_model_pyr, (st.pred_intensity, st.pred_vmap, st.pred_nmap)),
        "track_gn": (stage_track, (model_pyr, frame_pyr, st.model_rel)),
        "splat_render": (stage_render, (st.map_data, st.map_count, st.pose, st.tick)),
        "fuse+place": (stage_fuse, (fuse_data, st.map_count, pred, vmap_f, nmap_f, rgb,
                                    st.pose, st.tick)),
        "nid": (stage_nid, (st.kf_pose, st.kf_intensity, st.kf_depth, intensity, vmap_f,
                            st.pose)),
    }
    out = {name: timeit(fn, *a, device=dev) for name, (fn, a) in cases.items()}

    # full step, steady-state (replay the last frame repeatedly), op by op
    step = stepmod.make_step(intr, H, W, cfg)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    state = [st]

    def full(rgb, depth_raw):
        state[0], stats = step(state[0], rgb, depth_raw, eye, False, 1.0, 0.0)
        return stats

    out["FULL_STEP"] = timeit(full, rgb, depth_raw, iters=60, device=dev)
    cases["FULL_STEP"] = (full, (rgb, depth_raw))
    # one profiled call a stage: reading a profile of the full step's ~11,000
    # device operations takes the host seconds
    device_ms = xbench(cases, iters=1, quiet=True) if on_card else {}
    graphed = "full step (graphed)"
    if on_card:
        fe = eng.frontends["cam0"]  # its step: the graph the engine replays

        def full_graphed(rgb, depth_raw):
            fe.state, stats = fe.step_fn(fe.state, rgb, depth_raw, eye, False, 1.0, 0.0)
            return stats

        out[graphed] = timeit(full_graphed, rgb, depth_raw, iters=60, device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(60):
            full_graphed(rgb, depth_raw)
        end.record()
        torch.cuda.synchronize()
        device_ms[graphed] = start.elapsed_time(end) / 60

    whole = ("FULL_STEP", graphed)
    total = sum(v for k, v in out.items() if k not in whole)
    head = "device ms" if on_card else "device ms: not measured (CPU)"
    print(f"{'stage':<20} {'wall ms':>9}  {head}")
    for k, v in out.items():
        d = f"{device_ms[k]:9.3f}" if on_card else ""
        print(f"{k:<20} {v:9.3f}  {d}")
    if not on_card:
        print(f"{graphed:<20} not measured: CUDA graphs run on the card only")
    d_total = sum(v for k, v in device_ms.items() if k not in whole)
    print(f"{'sum(stages)':<20} {total:9.3f}  {f'{d_total:9.3f}' if on_card else ''}")
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    print(f"platform={dev} {name}")
    return dict(wall_ms=out, device_ms=device_ms)


if __name__ == "__main__":
    main()
