"""Two maps becoming one, in plain float32 `torch`: the inter-map
verification that finds where a camera stands in another camera's map,
and the merge that moves the camera's map into that one (the reference
system's `resolveRelativeTransformationFern` and `consumeReferenceFrame`,
`ReferenceFrame.h:34-150`).

- `verify`: the other map rendered at the fern candidate's pose (every
  live surfel, `splat.MODE_ALL`), the coverage gate, the dense track of
  the live frame onto the render from identity with the SO(3)
  pre-alignment, the gates on the track (failure, inlier share and
  count, ICP error, the covariance's largest diagonal entry), and the
  camera's pose in the other map: the candidate's pose times the track.
- `relative`: ``T_ab = pose_in_b . pose^-1``, map A's frame into map B's.
- `merge_maps`: A's live rows, positions and normals moved by ``T_ab``,
  appended in their order after B's count while B keeps one row of
  headroom (the rest are dropped and counted), then the map re-partitioned
  ``[inactive..., active...]`` by `surfel_map.compact` at the session tick.
- `move_poses`: a stack of camera-to-world poses moved by ``T_ab`` (each
  member camera's pose, keyframe pose and pose history, and A's fern
  keyframe poses, those that fit in B's database).

Departures from the reference system, each also the program's: the
verification renders the whole other map where the reference predicts its
INACTIVE model (`ReferenceFrame.h:72-80`); it tracks with the tracking
budget `iterations_for_levels()`, not the reference's interMap {50,50,50}
(`RGBDOdometry.cpp:387-389`); and it gates with the local loop's
thresholds.  The merge appends rows in their order and compacts, where the
reference's `GlobalModel::consume` draws them into the other model's
buffer with a shader.  The carried relative constraints move too in the
program; nothing here compares them.

Nothing here imports the program.  TF32 is off unless the caller's
`checks.tf32(True)` turns it on (the control).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import odometry, se3, splat
from . import surfel_map as sm
from .config import CameraIntrinsics, EngineConfig

COVERAGE_MIN = 0.2  # share of the render's pixels with depth


def full_map(rows: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A map of `capacity` rows holding `rows` [n, 16] from its first row,
    zero past them, and its count: the layout the render and the
    compaction read (the render's packed z-buffer keys depend on the
    capacity)."""
    dev = rows.device
    data = torch.zeros((capacity + 1, sm.COLS), dtype=torch.float32, device=dev)
    data[: rows.shape[0]] = rows
    return data, torch.full((), rows.shape[0], dtype=torch.int64, device=dev)


def verify(rgb: torch.Tensor, depth_raw: torch.Tensor, candidate: torch.Tensor,
           rows_b: torch.Tensor, capacity: int, cfg: EngineConfig, intr: CameraIntrinsics,
           width: int, height: int) -> Tuple[Optional[torch.Tensor], dict]:
    """The pose [4, 4] in map B of the camera that sees `rgb` (uint8
    [H, W, 3]) and `depth_raw` ([H, W], the sensor's units), starting from
    the fern `candidate`'s pose in B, against B's rows `rows_b`; None where
    a gate refuses it.  The dict holds the gates' readings."""
    dev = rows_b.device
    depth_m = depth_raw.to(torch.float32) / cfg.depth_factor
    frame = odometry.build_frame_pyramid(rgb, depth_m, intr, cfg.pyramid_levels)
    data, count = full_map(rows_b, capacity)
    pred = splat.render(data, count, candidate, intr, width, height, 0, mode=splat.MODE_ALL)
    del data
    info = {"coverage": float((pred.depth > 0).to(torch.float32).mean())}
    if info["coverage"] < COVERAGE_MIN:
        return None, info
    model = odometry.build_model_pyramid(pred.intensity, pred.vmap, pred.nmap,
                                         cfg.pyramid_levels)
    res = odometry.track(model, frame, torch.eye(4, dtype=torch.float32, device=dev), intr,
                         iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight,
                         use_so3=True)
    n_valid = float((frame.vmap[0][..., 2] > 0).to(torch.float32).sum())
    inliers = float(res.icp_inliers)
    info.update(failed=bool(res.failed), inlier_frac=inliers / max(n_valid, 1.0),
                icp_inliers=inliers, icp_error=float(res.icp_error),
                cov_max=float(torch.diagonal(odometry.covariance(res)).max()))
    if (info["failed"] or info["inlier_frac"] < cfg.loop_inlier_frac
            or inliers < cfg.icp_count_thresh * (width * height) / (640.0 * 480.0)
            or info["icp_error"] > cfg.loop_icp_err_thresh or info["cov_max"] > cfg.cov_thresh):
        return None, info
    return candidate @ res.A, info


def relative(pose_in_b: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """``T_ab`` [4, 4] float32: the camera's pose in map B times the inverse
    of its pose in its own map A, in float64."""
    t = pose_in_b.detach().cpu().double().numpy() @ np.linalg.inv(
        pose.detach().cpu().double().numpy())
    return torch.from_numpy(t.astype(np.float32))


def merge_maps(rows_b: torch.Tensor, rows_a: torch.Tensor, capacity: int, T_ab: torch.Tensor,
               time: float, time_delta: int, max_active: int) -> Tuple[torch.Tensor, int]:
    """Map A (`rows_a`, its rows below its count) merged into map B
    (`rows_b`, likewise) of `capacity` rows with ``T_ab``, then compacted
    at session tick `time`.  Returns (the merged map's rows below its
    count, A's live rows dropped for want of room)."""
    T = T_ab.to(rows_a.device, torch.float32)
    moved = rows_a[rows_a[:, sm.CONF] > 0].clone()
    moved[:, sm.POS] = se3.transform_points(T, moved[:, sm.POS])
    moved[:, sm.NORMAL] = se3.rotate_vectors(T, moved[:, sm.NORMAL])
    cb = rows_b.shape[0]
    take = min(moved.shape[0], max(capacity - cb - 1, 0))
    data, _ = full_map(torch.cat([rows_b, moved[:take]]), capacity)
    count = torch.full((), cb + take, dtype=torch.int64, device=data.device)
    m = sm.compact(sm.SurfelMap(data=data, count=count), time=time, time_delta=time_delta,
                   max_active=max_active)
    n = int(m.count)
    return m.data[:n].clone(), moved.shape[0] - take


def move_poses(T_ab: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Camera-to-world poses [..., 4, 4] moved into map B's frame."""
    return T_ab.to(poses.device, poses.dtype) @ poses
