"""Loop closure and relocalisation for one map (port of the local-loop and
fern parts of `densemonoslam_tpu.loops`).

- **Local loops**: render the INACTIVE model at the current pose, align the
  ACTIVE prediction onto it with the dense tracker, and on success feed
  sampled surface constraints to the deformation graph, folding the drifted
  recent map onto the old one and reactivating what is in view.
- **Ferns**: the keyframe database that relocalisation queries, with a
  geometric verification of the candidate pose.

- **Hybrid loops**: a world correction from the sparse tracker's loop
  pair deforms the map through constraints on a sparse grid of the ACTIVE
  prediction, with the INACTIVE prediction pinned.

- **Inter-map merges**: recognising the live view in another map's ferns
  (`resolve_intermap`), then absorbing that map: its surfels, relative
  constraints and fern keyframes, transformed into the other map's frame
  (`merge_maps`, `merge_rel_banks`, `consume_ferns`).

These run at the engine's loop-check cadence (hybrid loops when the sparse
tracker closes one).  The reference runs a loop as one jitted program with
`lax.cond` gates (inactive coverage, the tracking gates, the deformation's
acceptance); here each gate is one host read of a few device values, and
only what a gate lets through runs.

The stages are `utils.timer` spans named `loop.*` (profiler ranges, and
records keyed by the frame while the recorder is on), and each gate's read
is a child span `host.read`: where the card idles inside it the host
waits for it, elsewhere in a stage the host is at work.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.mapping import ferns as fernmod
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import splat, warp
from densemonoslam_tpu_torch.tracking import odometry
from densemonoslam_tpu_torch.utils import se3, timer
from densemonoslam_tpu_torch.utils.tensors import scalar


class LoopInfo(NamedTuple):
    attempted: bool
    closed: bool
    inactive_frac: float
    inlier_frac: float
    icp_error: float
    cons_error: float


class RelBank(NamedTuple):
    """Ring buffer of carried relative constraints: ~3 sampled constraints
    appended after every accepted local deformation, consumed by all later
    deformations of the map."""

    cons: dg.RelConstraint
    next: torch.Tensor  # [] int64 ring write pointer


def make_rel_bank(capacity: int = 64, device: torch.device | str = "cuda") -> RelBank:
    return RelBank(
        cons=dg.empty_rel(capacity, device),
        next=torch.zeros((), dtype=torch.int64, device=device),
    )


def rel_bank_from_numpy(d: Dict[str, np.ndarray], device: torch.device | str) -> RelBank:
    """A bank from numpy arrays keyed `src`, `dst`, `src_time`, `dst_time`,
    `valid` (the reference's `RelConstraint` fields) and `next`."""
    cons = dg.RelConstraint(**{
        k: torch.from_numpy(np.array(d[k])).to(
            device=device, dtype=torch.bool if k == "valid" else torch.float32
        )
        for k in dg.RelConstraint._fields
    })
    return RelBank(cons=cons, next=torch.as_tensor(int(d["next"]), device=device))


def _ring_put(old: torch.Tensor, dest: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`old` with rows `dest` set to `new`; a `dest` of len(old) is dropped."""
    buf = torch.cat([old, old[:1]])  # one spare row takes the dropped writes
    buf[dest] = new.to(old.dtype)
    return buf[: old.shape[0]]


def merge_rel_banks(dst: RelBank, src: RelBank, T: torch.Tensor) -> RelBank:
    """Map A's carried relative constraints, transformed by `T` into map B's
    frame, appended to B's ring (reference `consumeReferenceFrame` moves the
    member contexts' constraints)."""
    sel = src.cons.valid
    R = dst.cons.src.shape[0]
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    dest = torch.where(sel, (dst.next + rank) % R, R)
    d, s = dst.cons, src.cons
    return RelBank(
        cons=dg.RelConstraint(
            src=_ring_put(d.src, dest, se3.transform_points(T, s.src)),
            dst=_ring_put(d.dst, dest, se3.transform_points(T, s.dst)),
            src_time=_ring_put(d.src_time, dest, s.src_time),
            dst_time=_ring_put(d.dst_time, dest, s.dst_time),
            valid=_ring_put(d.valid, dest, s.valid),
        ),
        next=(dst.next + sel.sum()) % R,
    )


def _emit_relative(
    bank: RelBank, graph: dg.DeformGraph, cons: dg.Constraint, n_src: int
) -> RelBank:
    """After an accepted deformation, store ~3 spread samples of the point
    constraints as relative pairs (deformed src, original target); the target
    half of the constraint set is index-aligned with the source half, so its
    times are the targets' times."""
    P = n_src
    dev = cons.src.device
    moved = dg.deform_points(graph, cons.src[:P], cons.time[:P])
    sel = cons.valid[:P] & ~cons.pinned[:P] & (torch.arange(P, device=dev) % max(P // 3, 1) == 0)
    R = bank.cons.src.shape[0]
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    dest = torch.where(sel, (bank.next + rank) % R, R)  # row R is dropped
    c = bank.cons
    return RelBank(
        cons=dg.RelConstraint(
            src=_ring_put(c.src, dest, moved),
            dst=_ring_put(c.dst, dest, cons.dst[:P]),
            src_time=_ring_put(c.src_time, dest, cons.time[:P]),
            dst_time=_ring_put(c.dst_time, dest, cons.time[P : 2 * P]),
            valid=_ring_put(c.valid, dest, torch.ones((P,), dtype=torch.bool, device=dev)),
        ),
        next=(bank.next + sel.sum()) % R,
    )


def _constraints_from_alignment(
    act_vmap: torch.Tensor,  # [H,W,3] active prediction vertices (camera frame)
    act_time: torch.Tensor,  # [H,W] active last-seen ticks
    inact_depth: torch.Tensor,  # [H,W] inactive prediction depth
    inact_vmap: torch.Tensor,
    inact_time: torch.Tensor,
    A: torch.Tensor,  # active-camera -> inactive-camera correction
    pose: torch.Tensor,
    stride: int,
) -> dg.Constraint:
    """Surface constraints on a sparse pixel grid: pull each active point
    onto its ICP-corrected position, and pin the corresponding inactive
    point in place."""
    src_cam = warp.decimate(act_vmap, stride).reshape(-1, 3)
    t_src = warp.decimate(act_time, stride).reshape(-1)
    dst_cam = se3.transform_points(A, src_cam)
    d_in = warp.decimate(inact_depth, stride).reshape(-1)
    pin_cam = warp.decimate(inact_vmap, stride).reshape(-1, 3)
    t_pin = warp.decimate(inact_time, stride).reshape(-1)
    valid = (src_cam[:, 2] > 0) & (d_in > 0)
    src_w = se3.transform_points(pose, src_cam)
    dst_w = se3.transform_points(pose, dst_cam)
    pin_w = se3.transform_points(pose, pin_cam)
    return dg.Constraint(
        src=torch.cat([src_w, pin_w]),
        dst=torch.cat([dst_w, pin_w]),
        time=torch.cat([t_src, t_pin]),
        valid=torch.cat([valid, valid & (pin_cam[:, 2] > 0)]),
        pinned=torch.cat([torch.zeros_like(valid), torch.ones_like(valid)]),
    )


def _reactivate_in_view(
    data: torch.Tensor, count: torch.Tensor, pose: torch.Tensor, t_now, intr,
    width: int, height: int, depth_max: float = 25.0,
) -> torch.Tensor:
    """Bump sensor 0's last-seen tick to `t_now` for the live surfels whose
    (deformed) position projects into the view at `pose`, in place on
    `data` (returned).  Only in-view surfels: bumping every live surfel would
    push the active set past the windowed passes' tail block."""
    dev = data.device
    idx = torch.arange(data.shape[0] - 1, device=dev)
    alive = (data[:-1, sm.CONF] > 0) & (idx < count)
    p_c = se3.transform_points(se3.se3_inverse(pose), data[:-1, sm.POS])
    z = p_c[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = p_c[:, 0] / zs * intr.fx + intr.cx
    v = p_c[:, 1] / zs * intr.fy + intr.cy
    in_view = (z > 0.05) & (z < depth_max) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    data[:-1, 12] = torch.where(
        alive & in_view, scalar(t_now, torch.float32, dev), data[:-1, 12]
    )
    return data


def try_local_loop(
    state: stepmod.SlamState,
    camera: CameraConfig,
    cfg: EngineConfig,
    rel_bank: Optional[RelBank] = None,
) -> Tuple[stepmod.SlamState, LoopInfo, dg.DeformGraph, RelBank]:
    """Attempt a local (active-vs-inactive) loop closure at the current pose:
    INACTIVE render -> model-to-model tracking of the ACTIVE render onto it
    -> inlier/error/covariance gates -> constraints -> deformation graph ->
    on acceptance, the map (kernel K2, in place on `state.map_data`), the
    pose and the in-view reactivation.

    Returns (state, info, the applied graph (all-invalid when not closed),
    rel_bank).  Host reads: one per gate reached (coverage; tracking gates;
    acceptance), plus the tracker's own starvation reads; each a
    `host.read` span inside its stage's `loop.*` span."""
    intr = camera.intrinsics
    W, H = camera.resolution.width, camera.resolution.height
    dev = state.map_data.device
    levels = cfg.pyramid_levels
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0
    if rel_bank is None:
        rel_bank = make_rel_bank(device=dev)
    data, count, pose = state.map_data, state.map_count, state.pose
    t_now = state.tick
    t_f = t_now.to(torch.float32)

    def not_closed(*info):
        return state, LoopInfo(True, False, *info), dg.empty_graph(cfg.max_deform_nodes, dev), rel_bank

    with timer.span("loop.render_inactive"):
        pred_in = splat.render(
            data, count, pose, intr, W, H, t_now, time_delta=cfg.time_delta,
            mode=splat.MODE_INACTIVE,
        )
        inact = (pred_in.depth > 0).to(torch.float32).mean()
        with timer.span("host.read"):
            inact_frac = float(inact)  # gate 1
    if not inact_frac >= cfg.loop_min_inactive_frac:
        return not_closed(inact_frac, 0.0, 0.0, 0.0)

    with timer.span("loop.track"):
        pred_act = splat.render(
            data, count, pose, intr, W, H, t_now, time_delta=cfg.time_delta,
            mode=splat.MODE_ACTIVE, window=win,
        )
        model = odometry.build_model_pyramid(pred_in.intensity, pred_in.vmap, pred_in.nmap, levels)
        frame = odometry.frame_pyramid_from_maps(
            pred_act.intensity, pred_act.vmap, pred_act.nmap, levels
        )
        res = odometry.track(
            model, frame, torch.eye(4, dtype=torch.float32, device=dev), intr,
            iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight,
            use_so3=False,  # the two predictions share the pose
        )
        n_valid = (pred_act.depth > 0).to(torch.float32).sum()
        inlier_frac = res.icp_inliers / torch.clamp(n_valid, min=1.0)
        count_gate = cfg.icp_count_thresh * (W * H) / (640.0 * 480.0)
        cov_ok = torch.all(torch.diagonal(odometry.covariance(res)) < cfg.cov_thresh)
        go = (
            ~res.failed
            & (inlier_frac >= cfg.loop_inlier_frac)
            & (res.icp_inliers >= count_gate)
            & (res.icp_error <= cfg.loop_icp_err_thresh)
            & cov_ok
        )
        gate = torch.stack([go.to(torch.float32), inlier_frac, res.icp_error])
        with timer.span("host.read"):
            go_h, inlier_h, icp_err_h = gate.tolist()  # gate 2
    if not go_h > 0:
        return not_closed(inact_frac, inlier_h, icp_err_h, 0.0)

    with timer.span("loop.optimise"):
        cons = _constraints_from_alignment(
            pred_act.vmap, pred_act.time, pred_in.depth, pred_in.vmap, pred_in.time,
            res.A, pose, cfg.loop_constraint_stride,
        )
        graph = dg.sample_graph(data, count, cfg.max_deform_nodes, cfg.deform_graph_sample_rate)
        # anchor the old (inactive-epoch) part; deform the recent part
        frozen = graph.time < (t_f - cfg.time_delta)
        graph2, stats = dg.optimise_graphed(graph, cons, frozen=frozen, rel=rel_bank.cons)
        with timer.span("host.read"):
            cons_err = float(stats.mean_cons_error)  # gate 3
    if not cons_err <= cfg.loop_cons_err_thresh:
        return not_closed(inact_frac, inlier_h, icp_err_h, cons_err)

    with timer.span("loop.apply"):
        n_src = cons.src.shape[0] // 2  # [actives..., pins...]
        dg.apply_to_map(data, count, graph2)
        new_pose = dg.apply_to_pose(graph2, pose, t_f)
        _reactivate_in_view(data, count, new_pose, t_now, intr, W, H, depth_max=cfg.max_depth)
        rel_bank = _emit_relative(rel_bank, graph2, cons, n_src)
    new_state = state.replace(
        map_data=data,
        pose=new_pose,
        model_age=torch.full_like(state.model_age, stepmod.MODEL_INVALID_AGE),
    )
    return new_state, LoopInfo(True, True, inact_frac, inlier_h, icp_err_h, cons_err), graph2, rel_bank


def apply_hybrid_loop(
    state: stepmod.SlamState,
    correction: np.ndarray,  # [4,4] world-frame transform: corrected = C @ current
    camera: CameraConfig,
    cfg: EngineConfig,
    rel_bank: Optional[RelBank] = None,
) -> Tuple[stepmod.SlamState, LoopInfo, dg.DeformGraph]:
    """Global loop closure driven by an external (sparse-tracker) pose pair:
    constraints on a sparse grid of the ACTIVE prediction pull the map by
    the world correction ``C = pose_corrected @ inv(pose_estimate)``, the
    INACTIVE prediction's points are pinned, the deformation graph's old
    epoch is frozen, and the result is accepted when its mean constraint
    error is within twice `loop_cons_err_thresh` (the reference relaxes the
    hybrid gate).  On acceptance the map is deformed (kernel K2, in place on
    `state.map_data`), the pose takes C and what is in view is reactivated.

    Returns (state, info, the applied graph (all-invalid when not
    accepted)).  One host read: the acceptance and its error."""
    intr = camera.intrinsics
    W, H = camera.resolution.width, camera.resolution.height
    dev = state.map_data.device
    stride = cfg.loop_constraint_stride
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0
    if rel_bank is None:
        rel_bank = make_rel_bank(device=dev)
    C = torch.as_tensor(np.asarray(correction, np.float32), device=dev)
    data, count, pose = state.map_data, state.map_count, state.pose
    t_now = state.tick
    t_f = t_now.to(torch.float32)
    with timer.span("loop.hybrid_optimise"):
        pred_act = splat.render(
            data, count, pose, intr, W, H, t_now, time_delta=cfg.time_delta,
            mode=splat.MODE_ACTIVE, window=win,
        )
        pred_in = splat.render(
            data, count, pose, intr, W, H, t_now, time_delta=cfg.time_delta,
            mode=splat.MODE_INACTIVE,
        )
        src_cam = warp.decimate(pred_act.vmap, stride).reshape(-1, 3)
        t_src = warp.decimate(pred_act.time, stride).reshape(-1)
        valid = src_cam[:, 2] > 0
        src_w = se3.transform_points(pose, src_cam)
        dst_w = se3.transform_points(C, src_w)
        pin_cam = warp.decimate(pred_in.vmap, stride).reshape(-1, 3)
        t_pin = warp.decimate(pred_in.time, stride).reshape(-1)
        pin_w = se3.transform_points(pose, pin_cam)
        pin_ok = pin_cam[:, 2] > 0
        cons = dg.Constraint(
            src=torch.cat([src_w, pin_w]),
            dst=torch.cat([dst_w, pin_w]),
            time=torch.cat([t_src, t_pin]),
            valid=torch.cat([valid, pin_ok]),
            pinned=torch.cat([torch.zeros_like(valid), torch.ones_like(pin_ok)]),
        )
        graph = dg.sample_graph(data, count, cfg.max_deform_nodes, cfg.deform_graph_sample_rate)
        frozen = graph.time < (t_f - cfg.time_delta)
        graph2, stats = dg.optimise_graphed(graph, cons, frozen=frozen, rel=rel_bank.cons)
        accept = stats.mean_cons_error <= 2.0 * cfg.loop_cons_err_thresh
        gate = torch.stack([accept.to(torch.float32), stats.mean_cons_error])
        with timer.span("host.read"):
            accept_h, cons_err = gate.tolist()  # the one read
    info = LoopInfo(
        attempted=True, closed=accept_h > 0, inactive_frac=0.0, inlier_frac=1.0,
        icp_error=0.0, cons_error=cons_err,
    )
    if not accept_h > 0:
        return state, info, dg.empty_graph(cfg.max_deform_nodes, dev)
    with timer.span("loop.apply"):
        dg.apply_to_map(data, count, graph2)
        new_pose = C @ pose
        _reactivate_in_view(data, count, new_pose, t_now, intr, W, H, depth_max=cfg.max_depth)
    new_state = state.replace(
        map_data=data,
        pose=new_pose,
        model_age=torch.full_like(state.model_age, stepmod.MODEL_INVALID_AGE),
    )
    return new_state, info, graph2


class FernLoopState(NamedTuple):
    coder: fernmod.FernCoder
    db: fernmod.FernDB


def fern_factor(cfg: EngineConfig) -> int:
    """Fern downsampling factor (2^fern_pyr_level, 8 by default)."""
    return 1 << cfg.fern_pyr_level


def make_fern_state(
    camera: CameraConfig, cfg: EngineConfig, capacity: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> FernLoopState:
    f = fern_factor(cfg)
    w8, h8 = camera.resolution.width // f, camera.resolution.height // f
    return FernLoopState(
        coder=fernmod.make_coder(w8, h8, cfg.depth_cutoff, num_ferns=cfg.num_ferns, device=device),
        db=fernmod.empty_db(
            capacity or cfg.fern_db_capacity, h8, w8, num_ferns=cfg.num_ferns, device=device
        ),
    )


def fern_state_from_numpy(d: Dict[str, np.ndarray], device: torch.device | str) -> FernLoopState:
    """A fern state from numpy arrays keyed by the `FernCoder` and `FernDB`
    field names (`ux`, ..., `codes`, ..., `count`)."""

    def arr(k, dtype):
        return torch.from_numpy(np.array(d[k])).to(device=device, dtype=dtype)

    f32 = torch.float32
    coder = fernmod.FernCoder(
        ux=arr("ux", torch.int64), vy=arr("vy", torch.int64),
        thresh_rgb=arr("thresh_rgb", f32), thresh_d=arr("thresh_d", f32),
    )
    db = fernmod.FernDB(
        codes=arr("codes", torch.int32), poses=arr("poses", f32),
        intensity=arr("intensity", f32), depth=arr("depth", f32), times=arr("times", f32),
        count=arr("count", torch.int64),
    )
    return FernLoopState(coder=coder, db=db)


def update_ferns(
    fs: FernLoopState,
    rgb: torch.Tensor,
    depth_m: torch.Tensor,
    intensity: torch.Tensor,
    pose: torch.Tensor,
    t_now: int,
    thresh: float,
    factor: int = 8,
    max_capacity: int = 4096,
) -> Tuple[FernLoopState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode the frame, query the DB, and insert the frame if it is novel.
    Returns (state, code, best_idx, best_dissim).  The DB doubles in capacity
    when (almost) full, up to `max_capacity`; from there novel frames evict
    the most redundant stored keyframe.  One host read (the DB's count)."""
    db = fs.db
    if db.codes.shape[0] < max_capacity and int(db.count) >= db.codes.shape[0] - 1:
        db = fernmod.grow_db(db)
    rgb8 = fernmod.downsample_for_ferns(rgb.to(torch.float32), factor)
    d8 = fernmod.downsample_for_ferns(depth_m, factor)
    i8 = fernmod.downsample_for_ferns(intensity, factor)
    code = fernmod.encode(fs.coder, rgb8, d8)
    idx, dis = fernmod.best_match(db, code)
    db, _ = fernmod.add_frame(
        db, code, pose, i8, d8, time=float(t_now), min_dissim=dis, thresh=thresh,
        evict=db.codes.shape[0] >= max_capacity,
    )
    return FernLoopState(coder=fs.coder, db=db), code, idx, dis


def fern_recovery_pose(fs: FernLoopState, idx: int) -> np.ndarray:
    """The stored camera-to-world pose of fern keyframe `idx` (host copy)."""
    return fs.db.poses[idx].cpu().numpy()


def verify_recovery(
    frame_pyr: odometry.FramePyramid,
    recovery: torch.Tensor,  # [4,4] candidate camera pose in the map's frame
    map_data: torch.Tensor,
    map_count: torch.Tensor,
    camera: CameraConfig,
    cfg: EngineConfig,
    info: Optional[dict] = None,
):
    """Geometric verification of a candidate pose: render the map at it,
    dense-track the live frame onto the render, and gate on inlier fraction
    and count, ICP error and the pose covariance.

    Returns (refined pose [4,4] numpy or None, ok, info dict).  Host reads:
    the render's coverage, then one read of every gate value."""
    intr = camera.intrinsics
    W, H = camera.resolution.width, camera.resolution.height
    dev = map_data.device
    info = {} if info is None else info
    pred = splat.render(map_data, map_count, recovery, intr, W, H, 0, mode=splat.MODE_ALL)
    coverage = float((pred.depth > 0).to(torch.float32).mean())
    info["coverage"] = coverage
    if coverage < 0.2:
        return None, False, info
    model = odometry.build_model_pyramid(pred.intensity, pred.vmap, pred.nmap, cfg.pyramid_levels)
    res = odometry.track(
        model, frame_pyr, torch.eye(4, dtype=torch.float32, device=dev), intr,
        iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight, use_so3=True,
    )
    n_valid = (frame_pyr.vmap[0][..., 2] > 0).to(torch.float32).sum()
    cov_max = torch.diagonal(odometry.covariance(res)).max()
    failed, inliers, icp_err, n_valid, cov_max = torch.stack(
        [res.failed.to(torch.float32), res.icp_inliers, res.icp_error, n_valid, cov_max]
    ).tolist()
    inlier_frac = inliers / max(n_valid, 1.0)
    count_gate = cfg.icp_count_thresh * (W * H) / (640.0 * 480.0)
    info.update(inlier_frac=inlier_frac, icp_error=icp_err, icp_inliers=inliers, cov_max=cov_max)
    if (
        failed > 0
        or inlier_frac < cfg.loop_inlier_frac
        or inliers < count_gate
        or icp_err > cfg.loop_icp_err_thresh
        or cov_max > cfg.cov_thresh
    ):
        return None, False, info
    return (recovery @ res.A).cpu().numpy(), True, info


def _transform_rows(data_a: torch.Tensor, count_a: torch.Tensor, T: torch.Tensor):
    """Map A's rows with positions and normals moved by `T` into another
    map's frame, the live ones first in their order (dead rows get conf 0).
    Returns (rows [Na, 16], number of live rows as a 0-dim tensor)."""
    rows = data_a[:-1].clone()
    idx = torch.arange(rows.shape[0], device=rows.device)
    alive = (rows[:, sm.CONF] > 0) & (idx < count_a)
    rows[:, sm.POS] = se3.transform_points(T, rows[:, sm.POS])
    rows[:, sm.NORMAL] = se3.rotate_vectors(T, rows[:, sm.NORMAL])
    rows[:, sm.CONF] = torch.where(alive, rows[:, sm.CONF], 0.0)
    order = torch.argsort((~alive).to(torch.int8), stable=True)
    return rows[order], alive.sum()


def merge_maps(
    data_b: torch.Tensor,
    count_b: torch.Tensor,
    data_a: torch.Tensor,
    count_a: torch.Tensor,
    T_ab: torch.Tensor,  # map-A world -> map-B world
):
    """Absorb map A into map B (reference `GlobalModel::consume`): A's live
    surfels, transformed by `T_ab`, are appended after B's count while B
    keeps one row of headroom; the rest are dropped and counted.  No re-sort:
    the deformation graph sorts its sampled nodes by time, and the caller's
    next compaction restores the [inactive..., active...] partition.

    Writes `data_b` in place.  Returns (data_b, count, dropped) with
    `dropped` a host int: one host read (the counts)."""
    Nb = data_b.shape[0] - 1
    rows_a, n_alive = _transform_rows(data_a, count_a, T_ab)
    cb, n_alive = torch.stack([count_b.to(torch.int64), n_alive]).tolist()
    n_take = min(n_alive, max(Nb - cb - 1, 0), rows_a.shape[0])
    data_b[cb : cb + n_take] = rows_a[:n_take]
    count = torch.full((), min(cb + n_take, Nb), dtype=torch.int64, device=data_b.device)
    return data_b, count, n_alive - n_take


def consume_ferns(db_b: fernmod.FernDB, db_a: fernmod.FernDB, T_ab: torch.Tensor) -> fernmod.FernDB:
    """Absorb map A's fern keyframes into B's DB, poses moved by `T_ab`
    (reference `Ferns::consume`); keyframes past B's capacity are dropped.
    Writes B's tensors in place; one host read (the counts)."""
    K = db_b.codes.shape[0]
    cb, ca = torch.stack([db_b.count, db_a.count]).tolist()
    n = min(ca, K - cb)
    for arr_b, arr_a in (
        (db_b.codes, db_a.codes), (db_b.intensity, db_a.intensity),
        (db_b.depth, db_a.depth), (db_b.times, db_a.times),
    ):
        arr_b[cb : cb + n] = arr_a[:n]
    db_b.poses[cb : cb + n] = torch.einsum("ij,kjl->kil", T_ab, db_a.poses[:n])
    return db_b._replace(count=db_b.count + n)


def resolve_intermap(
    frame_pyr: odometry.FramePyramid,
    fern_code: torch.Tensor,
    other_db: fernmod.FernDB,
    other_map_data: torch.Tensor,
    other_map_count: torch.Tensor,
    camera: CameraConfig,
    cfg: EngineConfig,
    dissim_thresh: float = 0.45,
):
    """Try to localise the current frame inside ANOTHER map (reference
    `resolveRelativeTransformationFern`): fern retrieval in the other map,
    then `verify_recovery` against its model at the retrieved pose.

    Returns (pose in the other map [4,4] numpy or None, ok, info dict)."""
    idx, dis = fernmod.best_match(other_db, fern_code)
    info = {"dissim": float(dis)}
    if info["dissim"] > dissim_thresh:
        return None, False, info
    return verify_recovery(
        frame_pyr, other_db.poses.index_select(0, idx.reshape(1))[0], other_map_data,
        other_map_count, camera, cfg, info,
    )
