"""Per-stage breakdown of one accepted local loop closure on the PyTorch port
(the twin of `examples/profile_closure.py`).

Builds a map and state in the bench's closed-loop configuration, with the
INACTIVE overlap a closure needs, then times each stage of
`loops.try_local_loop` separately (each called once to warm up, then 5
calls synchronised once):

  render INACTIVE (full map) / render ACTIVE (windowed) / model-to-model
  track / graph sample / GN-CG optimise / apply_to_map (kernel K2) /
  reactivate + compact

and the whole closure end to end: the port runs the local loop op by op
around its GN-CG (one CUDA graph on the card), so "FULL fused closure" is
`loops.try_local_loop` on that state and bank, each call on a fresh copy of
the map (an accepted closure deforms and reactivates it in place).  The
stages run op by op, GN-CG included; on the card "GN-CG (graphed)" times
the graph the closure runs (`deformation.optimise_graphed`) on the same
inputs.  On the card the device time of one call of each stage (the summed
self time of its kernels, copies and fills under `torch.profiler`) stands
beside its wall time.

    python examples/torch_profile_closure.py [--platform cuda|cpu]

`PROFILE_SURFELS` (default 1<<21) sets the live rows of the 1<<22-row map.
"""

import argparse
import functools
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import splat
from densemonoslam_tpu_torch.tracking import odometry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_xbench import op_times  # noqa: E402

N_SURFELS = int(os.environ.get("PROFILE_SURFELS", str(1 << 21)))
CAPACITY = 1 << 22
W, H = 640, 480
T_NOW = 500


def config(capacity: int = CAPACITY) -> EngineConfig:
    return EngineConfig(
        max_surfels=capacity, depth_cutoff=8.0, depth_factor=1.0,
        nid_keyframing=True, open_loop=False, loop_check_interval=8,
        time_delta=30, deform_graph_sample_rate=2000, max_deform_nodes=256,
        loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
        pyramid_levels=4, track_row_stride=2,
    )


def build_state(n: int = N_SURFELS, capacity: int = CAPACITY, width: int = W,
                height: int = H, device="cuda") -> stepmod.SlamState:
    """The profiled state: `n` live rows, half an old epoch (inactive at
    t=500), half recent (active), in the same scene region so that the
    INACTIVE render overlaps the view; seeded."""
    rng = np.random.default_rng(0)
    data = np.zeros((capacity + 1, 16), np.float32)
    pts = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.5
    data[:n, 0:3] = pts
    data[:n, sm.CONF] = 15.0
    nm = rng.normal(0, 1, (n, 3))
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    data[:n, 8:11] = nm
    data[:n, sm.RADIUS] = 0.02
    half = n // 2
    data[:half, 12] = 10.0     # old epoch: inactive at t=500
    data[half:n, 12] = 495.0   # recent: active
    data[:half, sm.INIT_TIME] = np.linspace(0, 20, half)
    data[half:n, sm.INIT_TIME] = np.linspace(460, 495, n - half)
    state = stepmod.init_state(capacity, height, width, device=device)
    return state.replace(
        map_data=torch.from_numpy(data).to(device),
        map_count=torch.full((), n, dtype=torch.int64, device=device),
        tick=torch.full((), T_NOW, dtype=torch.int64, device=device),
    )


def _fresh(state: stepmod.SlamState) -> stepmod.SlamState:
    return state.replace(map_data=state.map_data.clone())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(name, fn, *args, n=5, fresh=None, device="cuda"):
    """Wall ms per call over `n` calls synchronised once, after one warm-up
    call; with `fresh`, every call gets `fresh(args)` made beforehand.  On
    the card the device ms of one more call under `torch.profiler` too (NaN
    where the profile holds no device operation).  Returns (output of the
    last call, wall ms, device ms or None)."""
    calls = [fresh(args) if fresh else args for _ in range(n + 2)]
    out = fn(*calls[0])
    _sync(device)
    t0 = time.perf_counter()
    for a in calls[1:n + 1]:
        out = fn(*a)
    _sync(device)
    wall = (time.perf_counter() - t0) / n * 1e3
    dev_ms = None
    if torch.device(device).type == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*calls[n + 1])
            torch.cuda.synchronize()
        ops = op_times(prof, True)
        # no device operation in the profile: the profiler lost them
        dev_ms = sum(t for _, _, t in ops) / 1e3 if ops else float("nan")
    d = f"{dev_ms:9.2f} ms device" if dev_ms is not None else ""
    print(f"{name:36s} {wall:9.2f} ms {d}", flush=True)
    return out, wall, dev_ms


def closure_graph(state, cfg, intr, width=W, height=H) -> dg.DeformGraph:
    """The optimised graph that `apply_to_map` (kernel K2) gets in the
    profile: the stages of `try_local_loop` up to the GN-CG, with no gate."""
    dev = state.map_data.device
    pose, t_now = state.pose, state.tick
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0
    pred_in = splat.render(state.map_data, state.map_count, pose, intr, width, height, t_now,
                           mode=splat.MODE_INACTIVE, time_delta=cfg.time_delta)
    pred_act = splat.render(state.map_data, state.map_count, pose, intr, width, height, t_now,
                            mode=splat.MODE_ACTIVE, window=win, time_delta=cfg.time_delta)
    model = odometry.build_model_pyramid(pred_in.intensity, pred_in.vmap, pred_in.nmap,
                                         cfg.pyramid_levels)
    frame = odometry.frame_pyramid_from_maps(pred_act.intensity, pred_act.vmap, pred_act.nmap,
                                             cfg.pyramid_levels)
    res = odometry.track(model, frame, torch.eye(4, dtype=torch.float32, device=dev), intr,
                         iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight,
                         use_so3=False)
    cons = loopsmod._constraints_from_alignment(
        pred_act.vmap, pred_act.time, pred_in.depth, pred_in.vmap, pred_in.time, res.A, pose,
        cfg.loop_constraint_stride,
    )
    graph = dg.sample_graph(state.map_data, state.map_count, cfg.max_deform_nodes,
                            cfg.deform_graph_sample_rate)
    frozen = graph.time < (float(t_now) - cfg.time_delta)
    return dg.optimise(graph, cons, frozen=frozen)[0]


def main(argv=None, n_surfels: int = N_SURFELS, capacity: int = CAPACITY, width: int = W,
         height: int = H, reps: int = 5) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.platform
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")
    intr = CameraIntrinsics.default_for(FrameResolution(width, height))
    cfg = config(capacity)
    state = build_state(n_surfels, capacity, width, height, device=dev)
    bank = loopsmod.make_rel_bank(device=dev)
    win = cfg.active_window
    camera = CameraConfig(FrameResolution(width, height), intr, "profile")
    t = functools.partial(timed, n=reps, device=dev)
    rows = {}

    # ---- the whole closure (what the engine runs) --------------------------
    s2, info, g, b2 = loopsmod.try_local_loop(_fresh(state), camera, cfg, rel_bank=bank)
    print(f"closure (loops.try_local_loop): closed={info.closed}  "
          f"inactive_frac={info.inactive_frac:.3f}  inlier_frac={info.inlier_frac:.3f}")
    run = functools.partial(loopsmod.try_local_loop, camera=camera, cfg=cfg)
    rows["FULL fused closure"] = t(
        "FULL fused closure", lambda st, bk: run(st, rel_bank=bk), state, bank,
        fresh=lambda a: (_fresh(a[0]), a[1]))[1:]

    # ---- stage by stage ----------------------------------------------------
    pose = state.pose
    r_in = functools.partial(splat.render, mode=splat.MODE_INACTIVE, time_delta=cfg.time_delta)
    pred_in, *rows["render INACTIVE (full map)"] = t(
        "render INACTIVE (full map)", r_in, state.map_data, state.map_count, pose, intr,
        width, height, T_NOW)
    r_act = functools.partial(splat.render, mode=splat.MODE_ACTIVE, window=win,
                              time_delta=cfg.time_delta)
    pred_act, *rows["render ACTIVE (windowed)"] = t(
        "render ACTIVE (windowed)", r_act, state.map_data, state.map_count, pose, intr,
        width, height, T_NOW)

    model = odometry.build_model_pyramid(pred_in.intensity, pred_in.vmap, pred_in.nmap,
                                         cfg.pyramid_levels)
    frame = odometry.frame_pyramid_from_maps(pred_act.intensity, pred_act.vmap, pred_act.nmap,
                                             cfg.pyramid_levels)
    trk = functools.partial(odometry.track, iterations=cfg.iterations_for_levels(),
                            icp_weight=cfg.icp_weight, use_so3=False)
    res, *rows["model-to-model track"] = t(
        "model-to-model track", trk, model, frame,
        torch.eye(4, dtype=torch.float32, device=dev), intr)

    sg = functools.partial(dg.sample_graph, max_nodes=cfg.max_deform_nodes,
                           sample_rate=cfg.deform_graph_sample_rate)
    graph, *rows["sample_graph"] = t("sample_graph", sg, state.map_data, state.map_count)

    cons = loopsmod._constraints_from_alignment(
        pred_act.vmap, pred_act.time, pred_in.depth, pred_in.vmap, pred_in.time, res.A, pose,
        cfg.loop_constraint_stride,
    )
    frozen = graph.time < (T_NOW - cfg.time_delta)
    (graph2, stats), *rows["GN-CG optimise (3x64)"] = t(
        "GN-CG optimise (3x64)", lambda g, c, f: dg.optimise(g, c, frozen=f), graph, cons, frozen)
    print(f"  mean_cons_error={float(stats.mean_cons_error):.4f}")
    if dev == "cuda":
        (_, gstats), *rows["GN-CG (graphed)"] = t(
            "GN-CG (graphed)", lambda g, c, f: dg.optimise_graphed(g, c, frozen=f), graph, cons,
            frozen)
        print(f"  mean_cons_error={float(gstats.mean_cons_error):.4f}")
    else:
        print(f"{'GN-CG (graphed)':36s} not measured: CUDA graphs run on the card only")

    _, *rows["apply_to_map"] = t("apply_to_map", dg.apply_to_map, state.map_data.clone(),
                                 state.map_count, graph2)

    rv = functools.partial(loopsmod._reactivate_in_view, intr=intr, width=width, height=height,
                           depth_max=cfg.max_depth)
    _, *rows["reactivate_in_view"] = t("reactivate_in_view", rv, state.map_data.clone(),
                                       state.map_count, pose, T_NOW)

    cp = functools.partial(sm.compact, time_delta=cfg.time_delta, max_active=win)
    _, *rows["compact (engine post-closure)"] = t(
        "compact (engine post-closure)", cp,
        sm.SurfelMap(data=state.map_data, count=state.map_count), float(T_NOW))
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"platform={dev} {name}")
    return dict(closed=info.closed, stages=rows, live=n_surfels,
                nodes=int(graph2.valid.sum()))


if __name__ == "__main__":
    main()
