"""The SLAM engine: host-side orchestration around the per-frame step (port
of `densemonoslam_tpu.engine`, single-camera open-loop path).

`Engine.process_frame` uploads a frame, runs `step.make_step`'s step, logs the
stats vector (the tracked pose rides in it) and compacts the map every 64
frames.  Modes that are not ported yet raise `NotImplementedError`: closed
loop (`open_loop=False`), relocalisation, ORB tracking, hybrid loops, depth
prediction and a second frontend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.utils.stats import SessionStats

_UNPORTED_MODES = ("relocalisation", "orb_tracking", "hybrid_loops", "predict_depth")


@dataclasses.dataclass
class Frontend:
    """Per-camera state (reference `Context`)."""

    name: str
    sensor_id: int
    camera: CameraConfig
    state: stepmod.SlamState
    step_fn: object
    tick: int = 0
    map_name: str = ""
    ts_log: List[float] = dataclasses.field(default_factory=list)
    stats_log: List[torch.Tensor] = dataclasses.field(default_factory=list)
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)

    @property
    def pose(self) -> np.ndarray:
        return self.state.pose.cpu().numpy()

    @pose.setter
    def pose(self, value: np.ndarray) -> None:
        self.state.pose = torch.as_tensor(
            np.asarray(value, np.float32), device=self.state.pose.device
        )

    @property
    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """(timestamp, camera-to-world pose) per processed frame."""
        if not self.stats_log:
            return []
        rows = torch.stack(self.stats_log).cpu().numpy()
        poses = rows[:, stepmod.STAT_POSE0:].reshape(-1, 4, 4)
        return list(zip(self.ts_log, poses))

    def finalize_stats(self) -> None:
        """Realise the logged stats vectors into `SessionStats`."""
        if not self.stats_log:
            return
        arr = torch.stack(self.stats_log).cpu().numpy()
        self.stats = SessionStats()
        for row in arr:
            self.stats.record(
                nid_score=float(row[stepmod.STAT_NID]),
                surfel_count=int(row[stepmod.STAT_SURFELS]),
                fused=bool(row[stepmod.STAT_FUSED] > 0),
            )
        self.stats.keyframes = int(arr[-1][stepmod.STAT_KEYFRAMES])


class Engine:
    """The SLAM engine (reference `ElasticFusion`), on one torch device."""

    def __init__(
        self,
        camera: CameraConfig,
        config: Optional[EngineConfig] = None,
        device: torch.device | str = "cpu",
    ):
        self.camera = camera
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        cfg = self.config
        if not cfg.open_loop:
            raise NotImplementedError(
                "loop closure is not ported yet: use EngineConfig(open_loop=True)"
            )
        for mode in _UNPORTED_MODES:
            if getattr(cfg, mode):
                raise NotImplementedError(f"EngineConfig.{mode} is not ported yet")
        self.frontends: Dict[str, Frontend] = {}
        self.global_tick = 0
        self._compact_interval = 64

    def frontend(self, name: str, sensor_id: Optional[int] = None) -> Frontend:
        """Create the camera frontend (with its own map)."""
        if name in self.frontends:
            return self.frontends[name]
        if self.frontends:
            raise NotImplementedError("a second frontend (multi-camera) is not ported yet")
        sensor_id = 0 if sensor_id is None else min(sensor_id, self.config.max_sensors - 1)
        res = self.camera.resolution
        fe = Frontend(
            name=name,
            sensor_id=sensor_id,
            camera=self.camera,
            state=stepmod.init_state(
                self.config.max_surfels, res.height, res.width, device=self.device
            ),
            step_fn=stepmod.make_step(
                self.camera.intrinsics, res.height, res.width, self.config, sensor_id
            ),
            map_name=name,
        )
        self.frontends[name] = fe
        return fe

    def _max_active(self) -> int:
        """Active-set cap for compaction: the windowed hot passes stream only
        `active_window` tail rows."""
        cfg = self.config
        return cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def map_of(self, map_name: str) -> sm.SurfelMap:
        st = self.frontends[map_name].state
        return sm.SurfelMap(data=st.map_data, count=st.map_count)

    def process_frame(
        self,
        name: str,
        rgb,
        depth_raw,
        timestamp: float,
        in_pose: Optional[np.ndarray] = None,
        sync: bool = True,
        cluster: int = 0,
    ) -> Dict[str, float]:
        """Process one frame for camera `name`.  `rgb` [H,W,3] and
        `depth_raw` [H,W] are numpy arrays or tensors; `in_pose`
        (camera-to-world) bypasses tracking (ground-truth injection).  With
        `sync=False` the stats are only logged and an empty dict returns."""
        if depth_raw is None:
            raise NotImplementedError("monocular depth prediction is not ported yet")
        fe = self.frontends[name]
        dev = self.device
        rgb = torch.as_tensor(rgb, device=dev)
        depth_raw = torch.as_tensor(depth_raw, device=dev).to(torch.float32)
        use_in = in_pose is not None
        if use_in:
            pose_in = torch.as_tensor(np.asarray(in_pose, np.float32), device=dev)
        else:
            pose_in = torch.eye(4, dtype=torch.float32, device=dev)
        fe.state = fe.state.replace(
            tick=torch.full((), self.global_tick, dtype=torch.int64, device=dev)
        )
        fe.state, stats = fe.step_fn(
            fe.state, rgb, depth_raw, pose_in, use_in,
            self.config.fusion_weight_multiplier, float(cluster),
        )
        self.global_tick += 1
        fe.ts_log.append(timestamp)
        fe.stats_log.append(stats)
        fe.tick += 1
        if fe.tick % self._compact_interval == 0:
            # reclaims culled slots and re-partitions [inactive..., active...]
            m = sm.compact(
                self.map_of(name), time=float(self.global_tick),
                time_delta=self.config.time_delta, max_active=self._max_active(),
            )
            fe.state = fe.state.replace(map_data=m.data, map_count=m.count)
        if not sync:
            return {}
        row = stats.cpu().numpy()
        return {
            "tracking_ok": float(row[stepmod.STAT_TRACK_OK]),
            "icp_error": float(row[stepmod.STAT_ICP_ERR]),
            "icp_inliers": float(row[stepmod.STAT_ICP_INL]),
            "nid": float(row[stepmod.STAT_NID]),
            "fused": float(row[stepmod.STAT_FUSED]),
            "fuse_matched": float(row[stepmod.STAT_MATCHED]),
            "fuse_added": float(row[stepmod.STAT_ADDED]),
            "culled": float(row[stepmod.STAT_CULLED]),
            "dropped": float(row[stepmod.STAT_DROPPED]),
            "surfels": float(row[stepmod.STAT_SURFELS]),
        }

    # ------------------------------------------------------------- exports
    def save_trajectory(self, name: str, path: str) -> None:
        from densemonoslam_tpu_torch.io.writers import save_freiburg

        traj = self.frontends[name].trajectory
        save_freiburg(path, [t for t, _ in traj], [p for _, p in traj])

    def save_ply(
        self, map_name: str, path: str, stable_only: bool = True,
        cluster: Optional[int] = None,
    ) -> int:
        """Export the map as PLY; `cluster` filters to one cluster id."""
        from densemonoslam_tpu_torch.io.writers import save_ply

        thr = self.config.confidence_threshold if stable_only else 0.0
        snap = sm.snapshot(self.map_of(map_name), conf_threshold=thr)
        keep = slice(None) if cluster is None else snap.clusters == cluster
        save_ply(
            path, snap.positions[keep], snap.normals[keep], snap.colors[keep], snap.radii[keep]
        )
        return int(snap.positions[keep].shape[0])

    def save_stats(self, name: str, path: str) -> None:
        fe = self.frontends[name]
        fe.finalize_stats()
        fe.stats.write(path)

    def surfel_count(self, map_name: str) -> int:
        return int(self.map_of(map_name).count)
