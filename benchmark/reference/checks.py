"""The comparisons that decide `correct`, and the readings they compare.

Every reading is a gap between what the program produced and what this
plain reference works out from the same inputs; a run is correct when each
gap is at or under its limit (the cell file's ``"limits"``).  The readings:

- ``start_pose_gap`` and ``start_map_gap``: the reference runs the first
  frames of the run from an empty map by itself, as the program did in its
  set-up through the same `Engine.process_frame`, and compares every pose
  (largest entry gap of the 4x4, metres and radians) and the map (both maps
  rendered by the reference's splat from the last pose, `map_gap`: the
  99.9th percentile of the per-pixel depth gap over the pixels either
  render covers, a pixel that only one covers counting as an infinite
  gap), in metres.
- ``window_step_pose_gap``, ``window_step_map_gap``: for window frames
  drawn from the seed, the reference runs the whole step (track, NID gate,
  fusion into the full map's active block, render of the stored
  prediction) from the program's state as the step was given it, and
  compares the pose, the block after the step and the prediction.
- ``closure_gap``: for accepted loop closures drawn from the window, the
  reference solves the deformation graph again from the program's
  constraints and nodes, deforms map rows drawn from the seed and the
  camera pose through its own graph, and compares positions, in metres.

`tf32(True)` computes the reference one precision below what the
configurations state (TF32 matmuls and convolutions): that is the control,
which has to fail.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import deform, deformation, splat
from . import step as rstep
from . import surfel_map as sm
from .config import CameraIntrinsics, EngineConfig


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and convolutions inside the block, as asked; the
    flags are restored on the way out."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def engine_config(config: dict) -> EngineConfig:
    return EngineConfig(**config["engine"])


def intrinsics(config: dict) -> CameraIntrinsics:
    c = config["camera"]
    return CameraIntrinsics(float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]))


def pose_gap(a, b) -> float:
    """Largest entry gap of two stacks of 4x4 poses."""
    a = torch.as_tensor(np.asarray(a, np.float64))
    b = torch.as_tensor(np.asarray(b, np.float64))
    return float((a - b).abs().max())


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


# ---------------------------------------------------------------- start
def run_start(config: dict, frames: Sequence, start_pose: np.ndarray, device) -> tuple:
    """The reference's own run over `frames` [(rgb, depth)] from an empty
    map at `start_pose`: (poses [F,4,4] numpy, map rows [count,16] tensor)."""
    cfg = engine_config(config)
    intr = intrinsics(config)
    H, W = int(config["camera"]["height"]), int(config["camera"]["width"])
    step = rstep.make_step(intr, H, W, cfg)
    state = rstep.init_state(cfg.max_surfels, H, W, device=device)
    state = state.replace(pose=_t(start_pose, device))
    eye = torch.eye(4, dtype=torch.float32, device=device)
    poses = []
    for i, (rgb, depth) in enumerate(frames):
        state = state.replace(tick=torch.full((), i, dtype=torch.int64, device=device))
        state, stats = step(state, _t(rgb, device, torch.uint8), _t(depth, device), eye,
                            False, cfg.fusion_weight_multiplier, 0.0)
        poses.append(stats[rstep.STAT_POSE0:].reshape(4, 4).cpu().numpy())
    n = int(state.map_count)
    rows = state.map_data[:n].clone()
    del state
    return np.stack(poses), rows


def render_depth(rows: torch.Tensor, pose: np.ndarray, config: dict) -> torch.Tensor:
    """Depth [H, W] of map rows [n, 16] seen from `pose`, every surfel."""
    intr = intrinsics(config)
    H, W = int(config["camera"]["height"]), int(config["camera"]["width"])
    dev = rows.device
    if rows.shape[0] == 0:
        return torch.zeros((H, W), dtype=torch.float32, device=dev)
    data = torch.cat([rows, torch.zeros((1, sm.COLS), dtype=rows.dtype, device=dev)])
    count = torch.full((), rows.shape[0], dtype=torch.int64, device=dev)
    pred = splat.render(data, count, _t(pose, dev), intr, W, H, 0.0, mode=splat.MODE_ALL)
    return pred.depth


GAP_QUANTILE = 0.999


def map_gap(depth_a: torch.Tensor, depth_b: torch.Tensor) -> float:
    """99.9th percentile over the pixels either depth covers of the depth
    gap (metres); a pixel that only one covers is an infinite gap.  A hole
    or a moved patch over more than a thousandth of the view shows."""
    va, vb = depth_a > 0, depth_b > 0
    either = va | vb
    if not bool(either.any()):
        return 0.0
    gap = torch.where(va & vb, (depth_a - depth_b).abs(), torch.full_like(depth_a, math.inf))
    return float(torch.quantile(gap[either].double().clamp(max=1e30), GAP_QUANTILE))


def start_readings(config: dict, frames: Sequence, start_pose: np.ndarray,
                   prog_poses: np.ndarray, prog_rows: torch.Tensor, device,
                   control: bool = False) -> Dict[str, float]:
    """``start_pose_gap`` and ``start_map_gap`` of the program's first
    frames (or, with `control`, of the reference in TF32 in its place)."""
    with tf32(False):
        ref_poses, ref_rows = run_start(config, frames, start_pose, device)
    if control:
        with tf32(True):
            prog_poses, prog_rows = run_start(config, frames, start_pose, device)
    last = ref_poses[-1]
    with tf32(False):
        d_ref = render_depth(ref_rows, last, config)
        d_prog = render_depth(prog_rows.to(device), last, config)
    return {"start_pose_gap": pose_gap(prog_poses, ref_poses),
            "start_map_gap": map_gap(d_prog, d_ref)}


# ----------------------------------------------------------- window step
STEP_FIELDS = rstep.STATE_FIELDS  # the state a step is given and returns


def step_block(cfg: EngineConfig, capacity: int, pixels: int) -> tuple:
    """(window, rows): a step reads and writes only the map's active tail
    block, rows [start, start + window) with start = clamp(count - window,
    0, capacity - window), and appends at most one row a pixel at `count`,
    inside rows [start, start + window + pixels)."""
    win = cfg.active_window if 0 < cfg.active_window < capacity else capacity
    return win, min(win + pixels, capacity)


def run_step(config: dict, smp: dict, net, device) -> tuple:
    """The reference's step on frame `smp` from the state copied before
    the program's (``smp["pre"]``: every field but the map, and the map's
    block from ``smp["start"]``, the rest of the map zero, which a step
    does not read), with the program's pose input and flag and the
    frame's depth (the reference's CNN's where `net` is given).  Returns
    the state after the step, the same block of its map and the step's
    stats row."""
    cfg = engine_config(config)
    H, W = int(config["camera"]["height"]), int(config["camera"]["width"])
    pre, start, cap = smp["pre"], int(smp["start"]), smp["capacity"]
    block = pre["block"].to(device)
    idx = torch.clamp(start + torch.arange(block.shape[0], device=device), max=cap)
    data = torch.zeros((cap + 1, block.shape[1]), dtype=block.dtype, device=device)
    data[idx] = block
    fields = {f: pre[f].to(device, copy=True) for f in STEP_FIELDS if f != "map_data"}
    state = rstep.SlamState(map_data=data, **fields)
    rgb = _t(smp["rgb"], device, torch.uint8)
    depth = net(rgb) if net is not None else _t(smp["depth"], device)
    use = smp["use_in"]
    use = use.to(device) if isinstance(use, torch.Tensor) else use
    step = rstep.make_step(intrinsics(config), H, W, cfg)
    new_state, stats = step(state, rgb, depth, smp["pose_in"].to(device), use, smp["weight"],
                            smp["cluster"])
    return new_state, new_state.map_data[idx], stats


def _block_rows(block: torch.Tensor, start: int, count, device) -> torch.Tensor:
    """The block's rows below the map's count."""
    return block[: max(int(count) - start, 0)].to(device)


def window_step_readings(config: dict, samples: List[dict], net, device,
                         control: bool = False, pose: str = "largest",
                         gaps: Optional[List[tuple]] = None) -> Dict[str, float]:
    """``window_step_pose_gap`` (the step's pose, in its state and in its
    stats row; the largest over `samples`) and
    ``window_step_map_gap`` (`map_gap` of the blocks after the step, both
    rendered by the reference from its pose, and of the stored
    predictions, each side's own render; the larger) over `samples`
    (`checks/window_step.py`).  With `pose` ``"median"`` the pose reading
    is ``window_step_pose_gap_median``: the median gap of the samples whose
    step tracked in the reference (its stats' track flag; a step that does
    not track keeps its pose on either side), or of all samples where none
    did.  `gaps`, where given, receives (frame, pose gap, tracked) of each
    sample."""
    pose_key = {"largest": "window_step_pose_gap", "median": "window_step_pose_gap_median"}[pose]
    if not samples:
        return {pose_key: math.inf, "window_step_map_gap": math.inf}
    pose_gaps, map_gaps, tracked = [], [], []
    keys = ("map_count", "pose", "pred_depth")
    for smp in samples:
        start = int(smp["start"])
        with tf32(False):
            r, r_block, r_row = run_step(config, smp, net, device)
            ref_post = dict({f: getattr(r, f) for f in keys}, block=r_block,
                            stats_pose=r_row[rstep.STAT_POSE0:])
            tracked.append(bool(r_row[rstep.STAT_TRACK_OK] > 0))
            del r
        prog = dict(smp["post"], stats_pose=smp["stats_pose"])
        if control:
            with tf32(True):
                c, c_block, c_row = run_step(config, smp, net, device)
                prog = dict({f: getattr(c, f) for f in keys}, block=c_block,
                            stats_pose=c_row[rstep.STAT_POSE0:])
                del c
        ref_pose = ref_post["pose"].cpu().numpy()
        pose_gaps.append(max(
            pose_gap(prog["pose"].cpu().numpy(), ref_pose),
            pose_gap(prog["stats_pose"].cpu().numpy(), ref_post["stats_pose"].cpu().numpy())))
        with tf32(False):
            d_ref = render_depth(_block_rows(ref_post["block"], start, ref_post["map_count"],
                                             device), ref_pose, config)
            d_prog = render_depth(_block_rows(prog["block"], start, prog["map_count"], device),
                                  ref_pose, config)
        map_gaps.append(max(map_gap(d_prog, d_ref),
                            map_gap(prog["pred_depth"].to(device),
                                    ref_post["pred_depth"].to(device))))
        del ref_post, prog, d_ref, d_prog
    if gaps is not None:
        gaps.extend((smp["frame"], g, t) for smp, g, t in zip(samples, pose_gaps, tracked))
    if pose == "largest":
        stat = max(pose_gaps)
    else:
        stat = statistics.median([g for g, t in zip(pose_gaps, tracked) if t] or pose_gaps)
    return {pose_key: stat, "window_step_map_gap": max(map_gaps)}


# -------------------------------------------------------------- closure
def _graph(g, device) -> deformation.DeformGraph:
    return deformation.DeformGraph(*(x.to(device) for x in g))


def closure_solve(cap: dict, device) -> tuple:
    """The reference's graph solved from the program's constraints and
    nodes, and the sampled rows (as the check was given them) and the
    camera pose deformed through it."""
    sol = cap["solve"]
    cons = deformation.Constraint(*(x.to(device) for x in sol["cons"]))
    rel = None if sol["rel"] is None else deformation.RelConstraint(
        *(x.to(device) for x in sol["rel"]))
    graph, _ = deformation.optimise(_graph(sol["graph"], device), cons,
                                    frozen=sol["frozen"].to(device), rel=rel)
    rows = cap["rows_before"].to(device)
    n = rows.shape[0]
    data = torch.cat([rows, torch.zeros((1, sm.COLS), dtype=rows.dtype, device=device)])
    deform.deform_map_reference(data, torch.full((), n, dtype=torch.int64, device=device), graph)
    pose = deformation.apply_to_pose(graph, cap["pose_before"].to(device),
                                     cap["tick"].to(device).to(torch.float32))
    return data[:n], pose


def closure_readings(config: dict, captures: List[dict], device,
                     control: bool = False) -> Dict[str, float]:
    """``closure_gap`` over the captured closures: the largest position gap
    of a sampled row (metres) or entry gap of the camera pose, the graph
    solved again from the program's inputs."""
    if not captures:
        return {"closure_gap": math.inf}
    gaps = []
    for cap in captures:
        rows, pose = cap["rows_after"].to(device), cap["pose_after"].to(device)
        with tf32(False):
            ref_rows, ref_pose = closure_solve(cap, device)
        if control:
            with tf32(True):
                rows, pose = closure_solve(cap, device)
        gaps.append(max(float((rows[:, sm.POS] - ref_rows[:, sm.POS]).abs().max()),
                        pose_gap(pose.cpu().numpy(), ref_pose.cpu().numpy())))
    return {"closure_gap": max(gaps)}
