"""The monocular frame, plain: depth from the CNN (`depthnet.DepthNet`),
the sparse tracker's frame chain (`sparse`: detect, match, motion-only
pose against the previous frame's keypoints) and the dense step fed the
chain's pose, as `Engine.process_frame` runs them with `predict_depth`
and `orb_tracking`.  The readings of the monocular checks:

- ``depth_gap``: window frames drawn from the seed, the largest relative
  gap of the program's predicted depth from the reference's;
- ``sparse_pose_gap``: the same frames, the tracker's pose worked out
  again from the tracker's previous keypoints and poses as handed over
  (step by step), with the reference's own depth;
- ``ba_pose_gap``: local bundle adjustments of the window drawn from the
  seed, the reference detecting and matching the window's keyframes again
  from their frames with its own depth and solving from the poses the
  program's solve started from (`ba.local_ba`);
- ``mono_start_pose_gap`` and ``mono_start_map_gap``: the run's first
  frames from an empty map, the reference running CNN, chain and step by
  itself (`checks.pose_gap`, `checks.map_gap` as for RGB-D)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import ba, checks, preprocess, sparse
from . import step as rstep
from .checks import tf32
from .depthnet import DepthNet


def _octaves(config: dict) -> int:
    return int((config.get("tracker") or {}).get("octaves", sparse.OCTAVES))


def chain_step(config: dict, net: DepthNet, rgb: torch.Tensor, prev, pose: torch.Tensor):
    """One frame of the tracker's chain: (depth, keypoints, pose, ok) from
    the previous (keypoints, pose) `prev` (None on the first frame) and the
    tracker's current pose."""
    cfg = checks.engine_config(config)
    depth = net(rgb)
    kp = sparse.detect_pyramid(preprocess.rgb_to_intensity(rgb), depth / cfg.depth_factor,
                               sparse.FAST_THRESHOLD_MIN, sparse.FAST_THRESHOLD,
                               octaves=_octaves(config))
    if prev is None:
        return depth, kp, pose, torch.ones((), dtype=torch.bool, device=rgb.device)
    prev_kp, prev_pose = prev
    matches, _ = sparse.match(prev_kp, kp)
    A, inl, err = sparse.motion_only_pose(prev_kp, kp, matches, checks.intrinsics(config),
                                          torch.eye(4, dtype=torch.float32, device=rgb.device))
    ok = (inl >= 15) & (err < 5.0)
    return depth, kp, torch.where(ok, prev_pose @ A, pose), ok


def run_start(config: dict, net: DepthNet, rgbs: Sequence, start_pose, device) -> tuple:
    """The reference's own monocular run over `rgbs` from an empty map:
    (poses [F,4,4] numpy, map rows [count,16] tensor)."""
    cfg = checks.engine_config(config)
    intr = checks.intrinsics(config)
    H, W = int(config["camera"]["height"]), int(config["camera"]["width"])
    step = rstep.make_step(intr, H, W, cfg)
    state = rstep.init_state(cfg.max_surfels, H, W, device=device)
    pose = checks._t(start_pose, device)
    state = state.replace(pose=pose)
    prev, poses = None, []
    for i, rgb in enumerate(rgbs):
        rgb = checks._t(rgb, device, torch.uint8)
        depth, kp, pose, ok = chain_step(config, net, rgb, prev, pose)
        prev = (kp, pose)
        state = state.replace(tick=torch.full((), i, dtype=torch.int64, device=device))
        state, stats = step(state, rgb, depth, pose, ok, cfg.fusion_weight_multiplier, 0.0)
        poses.append(stats[rstep.STAT_POSE0:].reshape(4, 4).cpu().numpy())
    n = int(state.map_count)
    rows = state.map_data[:n].clone()
    del state
    return np.stack(poses), rows


def start_readings(config: dict, net: DepthNet, rgbs: Sequence, start_pose, prog_poses,
                   prog_rows, device, control: bool = False) -> Dict[str, float]:
    with tf32(False):
        ref_poses, ref_rows = run_start(config, net, rgbs, start_pose, device)
    if control:
        with tf32(True):
            prog_poses, prog_rows = run_start(config, net, rgbs, start_pose, device)
    with tf32(False):
        d_ref = checks.render_depth(ref_rows, ref_poses[-1], config)
        d_prog = checks.render_depth(prog_rows.to(device), ref_poses[-1], config)
    return {"mono_start_pose_gap": checks.pose_gap(prog_poses, ref_poses),
            "mono_start_map_gap": checks.map_gap(d_prog, d_ref)}


def depth_readings(net: DepthNet, samples: List[dict], device,
                   control: bool = False) -> Dict[str, float]:
    """``depth_gap`` over `samples`, each ``{"rgb", "depth"}`` (the
    program's predicted depth of that frame)."""
    if not samples:
        return {"depth_gap": math.inf}
    gaps = []
    for smp in samples:
        rgb = checks._t(smp["rgb"], device, torch.uint8)
        with tf32(False):
            ref = net(rgb)
        prog = smp["depth"].to(device)
        if control:
            with tf32(True):
                prog = net(rgb)
        gaps.append(float(((prog - ref).abs() / ref).max()))
    return {"depth_gap": max(gaps)}


def sparse_readings(config: dict, net: DepthNet, samples: List[dict], device,
                    control: bool = False) -> Dict[str, float]:
    """``sparse_pose_gap`` over `samples`, each ``{"rgb", "prev_kp",
    "prev_pose", "pose_in", "pose"}``: the tracker's state as the frame was
    handed over and the pose it returned."""
    if not samples:
        return {"sparse_pose_gap": math.inf}

    def chain(smp):
        prev = (sparse.Keypoints(*(x.to(device) for x in smp["prev_kp"])),
                smp["prev_pose"].to(device))
        rgb = checks._t(smp["rgb"], device, torch.uint8)
        return chain_step(config, net, rgb, prev, smp["pose_in"].to(device))[2].cpu().numpy()

    gaps = []
    for smp in samples:
        with tf32(False):
            ref = chain(smp)
        prog = smp["pose"].numpy()
        if control:
            with tf32(True):
                prog = chain(smp)
        gaps.append(checks.pose_gap(prog, ref))
    return {"sparse_pose_gap": max(gaps)}


def keypoints(config: dict, net: DepthNet, rgb, device) -> sparse.Keypoints:
    """The tracker's keypoints of frame `rgb` with the reference's depth."""
    cfg = checks.engine_config(config)
    rgb = checks._t(rgb, device, torch.uint8)
    depth = net(rgb)
    return sparse.detect_pyramid(preprocess.rgb_to_intensity(rgb), depth / cfg.depth_factor,
                                 sparse.FAST_THRESHOLD_MIN, sparse.FAST_THRESHOLD,
                                 octaves=_octaves(config))


def ba_readings(config: dict, net: DepthNet, samples: List[dict], device,
                control: bool = False) -> Dict[str, float]:
    """``ba_pose_gap`` over `samples`, each ``{"rgbs", "poses_in", "out"}``:
    the window keyframes' frames, the poses the program's solve started
    from and the poses it returned; a solve the reference does not make is
    an infinite gap."""
    if not samples:
        return {"ba_pose_gap": math.inf}
    intr = checks.intrinsics(config)

    def solve(smp):
        kps = [keypoints(config, net, rgb, device) for rgb in smp["rgbs"]]
        out = ba.local_ba(kps, smp["poses_in"], intr, device)
        return None if out is None else out.cpu().numpy()

    gaps = []
    for smp in samples:
        with tf32(False):
            ref = solve(smp)
        prog = smp["out"]
        if control:
            with tf32(True):
                prog = solve(smp)
        if ref is None or prog is None:
            gaps.append(math.inf)
            continue
        gaps.append(checks.pose_gap(prog, ref))
    return {"ba_pose_gap": max(gaps)}
