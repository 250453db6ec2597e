"""The SLAM engine: host-side orchestration around the per-frame step (port
of `densemonoslam_tpu.engine`).

`Engine.process_frame` uploads a frame, runs the step, logs the stats
vector, records the tracked pose in a device pose history and compacts the
map every 64 frames.  On the card the step is one CUDA graph per camera
(`step.make_graphed_step`), captured at the camera's first frame: the
camera's state is the graph's, updated in place, and the map backend's
tensors are every member camera's graph buffers, so a new map from outside
the step (a compaction, a closure, a merge, a checkpoint) is copied into
them.  Unless `open_loop`, every
`loop_check_interval` frames it updates the fern keyframe database and tries
a local loop closure; an accepted closure rewrites the pose history and the
fern poses through the deformation graph and re-partitions the map.  With
`relocalisation`, a lagged poll of the step's device-side bad-frame counter
detects a lost camera and `relocalise` recovers it through the ferns.

Monocular mode (`predict_depth`) takes depth from the attached depth CNN
before tracking.  With `orb_tracking` the sparse tracker supplies the pose
and its ok flag to the step as device values (no host branch); when its
pose graph is re-optimised the pose history is rewritten from the keyframe
corrections, and with `hybrid_loops` its loop pairs drive a hybrid closure
of the dense map.

Several cameras share one engine, one process and one card, as the
reference multiplexes its contexts through one GPU: each `frontend` is a
camera with its own state and sensor id, in a map of its own.  At the
loop-check cadence a camera whose view another map's ferns recognise, and
whose pose there passes the geometric verification, merges its map into
that one (`merge_into`); `batch_align` aligns two cameras' views without an
initial guess.  Frontends that share a map fuse into the one map tensor:
each step installs the map's current tensors first, and a compaction or a
merge hands its new tensors to every member frontend.

Tracing (`utils.timer`): each frame's work is a tree of spans under the
root `frame` (`frame.upload`, `frame.depth_cnn` with device events,
`frame.sparse_track`, `frame.dense_step`, `frame.pace`, `frame.compact`,
and at the cadence `loop.ferns`, `loop.check`, `loop.intermap`), each
keyed by the frame id, the session tick that `process_frame` sets when it
starts; they are profiler ranges, and records while the recorder is on.
`Frontend.loop_checks` counts the loop closures a camera attempted (each
`try_local_loop` call and each hybrid closure of the sparse tracker's loop
pair), beside `loops_closed`, those accepted; `intermap_checks` counts its
queries of another map that reached `resolve_intermap`, beside
`intermap_merges`, those that verified and merged its map into the other.
A merge's work is the spans `merge.maps`, `merge.compact` and
`merge.members`; the moved cameras capture their steps again at their next
frame, inside `step.capture` (`utils.graphs`).  `stage_ms` reads the device
times of a camera's step stages, stamped inside its graph.

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.mapping import ferns as fernmod
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import preprocess, splat
from densemonoslam_tpu_torch.tracking import odometry, registration
from densemonoslam_tpu_torch.tracking.sparse import SparseTracker
from densemonoslam_tpu_torch.utils import graphs, timer
from densemonoslam_tpu_torch.utils.stats import SessionStats
from densemonoslam_tpu_torch.utils.timer import Stopwatch

_HIST_INITIAL_CAP = 1024
# indexed writes into the pose histories, two per flush: a run reads this to
# show that frames between flushes write nothing
HIST_WRITES = 0
# bounded-pacing waits (`Engine.process_frame`), counted on every device: a
# run reads this to see on which frames the engine waited
PACING_WAITS = 0
_PACING_LAG = 8  # wait on the frame this many stats rows back


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
    # device pose history [cap,4,4] + per-pose session ticks [cap]: each
    # frame's pose is queued on the host and the queue lands in one indexed
    # write per tensor whenever the history is read (a loop closure, an
    # export, a checkpoint), into buffers that double when full.  A write
    # per frame would be a tiny launch serialised with the step.  Accepted
    # loop closures rewrite it through the deformation graph, so exported
    # trajectories reflect closures, not raw odometry.
    _pose_hist_buf: Optional[torch.Tensor] = None
    _hist_times_buf: Optional[torch.Tensor] = None
    _hist_pending: List[Tuple[torch.Tensor, int, float]] = dataclasses.field(default_factory=list)
    ts_log: List[float] = dataclasses.field(default_factory=list)
    stats_log: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # on the card, a CUDA event recorded after each of the last
    # `_PACING_LAG` frames' work, the newest last (the bounded pacing)
    frame_events: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_PACING_LAG))
    # on the card with relocalisation: per frame, (event, pinned host copy
    # of the stats row's bad-frame count), the newest last; the lagged poll
    # waits on the oldest's event alone
    bad_counts: Optional[collections.deque] = None
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    fern_state: Optional[loopsmod.FernLoopState] = None
    loop_checks: int = 0  # loop closures attempted: local checks and hybrid closures
    loops_closed: int = 0  # and accepted
    intermap_checks: int = 0  # queries of another map that reached `resolve_intermap`
    intermap_merges: int = 0  # and those that verified: this camera's map moved
    last_loop_info: Optional[loopsmod.LoopInfo] = None
    last_loop_graph: Optional[dg.DeformGraph] = None  # of the last accepted closure
    sparse_tracker: Optional[SparseTracker] = None
    lost: bool = False
    consecutive_bad: int = 0

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
        """(timestamp, camera-to-world pose) per processed frame, from the
        pose history (corrected by accepted loop closures)."""
        n = len(self.ts_log)
        if n == 0:
            return []
        return list(zip(self.ts_log, self.pose_hist[:n].cpu().numpy()))

    @property
    def pose_hist(self) -> Optional[torch.Tensor]:
        self._flush_hist()
        return self._pose_hist_buf

    @pose_hist.setter
    def pose_hist(self, value: Optional[torch.Tensor]) -> None:
        # queued poses land in the old buffer first, so a replacement never
        # drops recorded poses silently
        self._flush_hist()
        self._pose_hist_buf = value

    @property
    def hist_times(self) -> Optional[torch.Tensor]:
        self._flush_hist()
        return self._hist_times_buf

    @hist_times.setter
    def hist_times(self, value: Optional[torch.Tensor]) -> None:
        self._flush_hist()
        self._hist_times_buf = value

    def record_pose(self, stats_row: torch.Tensor, session_tick: int) -> None:
        """Queue this frame's tracked pose (stats rows 13:29) for the
        history; touches no tensor."""
        n = len(self.ts_log)  # the caller appends ts_log right after
        self._hist_pending.append((stats_row, n, float(session_tick)))

    def _flush_hist(self) -> None:
        """Land the queued poses: one indexed write per history tensor."""
        global HIST_WRITES
        if not self._hist_pending:
            return
        pending, self._hist_pending = self._hist_pending, []
        dev = pending[0][0].device
        max_n = max(n for _, n, _ in pending)
        if self._pose_hist_buf is None:
            self._pose_hist_buf = torch.zeros((_HIST_INITIAL_CAP, 4, 4), dtype=torch.float32,
                                              device=dev)
            self._hist_times_buf = torch.zeros((_HIST_INITIAL_CAP,), dtype=torch.float32,
                                               device=dev)
        while max_n >= self._pose_hist_buf.shape[0]:
            self._pose_hist_buf = torch.cat(
                [self._pose_hist_buf, torch.zeros_like(self._pose_hist_buf)])
            self._hist_times_buf = torch.cat(
                [self._hist_times_buf, torch.zeros_like(self._hist_times_buf)])
        poses = torch.stack([row[stepmod.STAT_POSE0 :].reshape(4, 4) for row, _, _ in pending])
        # rows and ticks in one copy, from pinned memory on the card so that
        # it does not wait for the device (f64 holds both exactly)
        host = torch.tensor([(n, t) for _, n, t in pending], dtype=torch.float64,
                            pin_memory=dev.type == "cuda")
        idx_ticks = host.to(dev, non_blocking=True)
        idx = idx_ticks[:, 0].long()
        self._pose_hist_buf[idx] = poses
        self._hist_times_buf[idx] = idx_ticks[:, 1].float()
        HIST_WRITES += 2

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

    @property
    def num_keyframes(self) -> int:
        return int(self.state.kf_count)


@dataclasses.dataclass
class MapBackend:
    """Per-map state (reference `ReferenceFrame`): the canonical surfel
    tensor, which its frontends' states hold too (the same tensor, updated
    in place by fusion and by loop closures)."""

    name: str
    map_data: Optional[torch.Tensor] = None  # [N+1, 16]
    map_count: Optional[torch.Tensor] = None  # []
    contexts: List[str] = dataclasses.field(default_factory=list)  # member frontends
    deforms: int = 0
    dropped: int = 0  # surfels lost to capacity in merges
    # carried relative constraints: emitted by accepted local deformations,
    # consumed by every later deformation of this map
    rel_bank: Optional[loopsmod.RelBank] = None

    def get_rel_bank(self) -> loopsmod.RelBank:
        if self.rel_bank is None:
            self.rel_bank = loopsmod.make_rel_bank(device=self.map_data.device)
        return self.rel_bank


class Engine:
    """The SLAM engine (reference `ElasticFusion`), on one torch device."""

    def __init__(
        self,
        camera: CameraConfig,
        config: Optional[EngineConfig] = None,
        device: torch.device | str = "cuda",
    ):
        self.camera = camera
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on the card by default and no CUDA device is available: "
                'pass device="cpu" to run on the CPU'
            )
        self.frontends: Dict[str, Frontend] = {}
        self.maps: Dict[str, MapBackend] = {}
        self.global_tick = 0
        self.timer = Stopwatch()
        self._compact_interval = 64
        self._step_cache: Dict[Tuple, object] = {}
        self._stages: Dict[str, Optional[timer.StageRing]] = {}  # each camera's step stamps
        self._depth_predictor = None

    def set_depth_predictor(self, predictor) -> None:
        """Attach a monocular depth network (`models.depthnet.DepthPredictor`,
        used with `predict_depth=True`)."""
        self._depth_predictor = predictor

    def _step_for(self, camera: CameraConfig, sensor_id: int, name: str):
        """The step of camera `name` for its geometry, sensor and the current
        config, built once per distinct key: a config swap back to an earlier
        value reuses its step.  Each camera has its own: on the card its
        graph holds that camera's state, compiled at its first frame, and
        everywhere its stage stamps are that camera's."""
        res = camera.resolution
        key = (camera.intrinsics, res.width, res.height, sensor_id, self.config, name)
        if key not in self._step_cache:
            self._step_cache[key] = stepmod.make_device_step(
                camera.intrinsics, res.height, res.width, self.config, sensor_id, self.device
            )
        step = self._step_cache[key]
        self._stages[name] = getattr(step, "stages", None)  # a wrapped step may have none
        return step

    def _recompile(self, fe: Frontend) -> None:
        """Drop camera `fe`'s graphs: its next frame captures its step again,
        over the map it is in now."""
        for key in [k for k in self._step_cache if k[-1] == fe.name]:
            del self._step_cache[key]
        fe.step_fn = self._step_for(fe.camera, fe.sensor_id, fe.name)

    def update_config(self, **kw) -> None:
        """Live parameter change (the reference GUI's slider sync): every
        frontend's step is re-derived through the step cache."""
        self.config = self.config.replace(**kw)
        for fe in self.frontends.values():
            fe.step_fn = self._step_for(fe.camera, fe.sensor_id, fe.name)

    def frontend(self, name: str, sensor_id: Optional[int] = None) -> Frontend:
        """Create a camera frontend in its own new map (reference
        `ElasticFusion::frontend`); sensor ids count up from 0."""
        if name in self.frontends:
            return self.frontends[name]
        sensor_id = len(self.frontends) if sensor_id is None else sensor_id
        sensor_id = min(sensor_id, self.config.max_sensors - 1)
        res = self.camera.resolution
        fe = Frontend(
            name=name,
            sensor_id=sensor_id,
            camera=self.camera,
            state=stepmod.init_state(
                self.config.max_surfels, res.height, res.width, device=self.device
            ),
            step_fn=self._step_for(self.camera, sensor_id, name),
            map_name=name,
        )
        self.frontends[name] = fe
        self.maps[name] = MapBackend(
            name=name, map_data=fe.state.map_data, map_count=fe.state.map_count, contexts=[name]
        )
        return fe

    def backend_of(self, name: str) -> MapBackend:
        return self.maps[self.frontends[name].map_name]

    def _max_active(self) -> int:
        """Active-set cap for compaction: the windowed hot passes stream only
        `active_window` tail rows."""
        cfg = self.config
        return cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def _set_map(self, be: MapBackend, data: torch.Tensor, count: torch.Tensor) -> None:
        """New map tensors for the backend and every member frontend.  On the
        card the backend keeps its tensors, the member steps' graph buffers:
        new contents are copied into them (`graphs.STATE_COPIES`), and a map
        of another shape makes every member compile its step again."""
        if self.device.type == "cuda" and be.map_data is not None:
            if data.shape == be.map_data.shape and data.dtype == be.map_data.dtype:
                if data is not be.map_data:
                    graphs.copy_state(be.map_data, data)
                if count is not be.map_count:
                    graphs.copy_state(be.map_count, count)
                data, count = be.map_data, be.map_count
            else:
                for name in be.contexts:
                    self._recompile(self.frontends[name])
        be.map_data, be.map_count = data, count
        for name in be.contexts:
            fe = self.frontends[name]
            fe.state = fe.state.replace(map_data=data, map_count=count)

    def _compact_now(self, be: MapBackend) -> None:
        """Re-partition the map [inactive..., active...] now; after a closed
        loop this brings the reactivated surfels into the active tail window
        that tracking and fusion stream."""
        m = sm.compact(
            self.map_of(be.name), time=float(self.global_tick),
            time_delta=self.config.time_delta, max_active=self._max_active(),
        )
        self._set_map(be, m.data, m.count)

    def _rewrite_history_from_pgo(self, fe: Frontend, ev) -> None:
        """Apply the sparse tracker's PGO keyframe corrections to the pose
        history: `ev` = (kf_ticks, kf_poses_before, kf_poses_after), whose
        ticks index this camera's frames; each history row takes the delta
        of the last keyframe at or before it.  One host-to-device copy."""
        n = len(fe.ts_log)
        kf_ticks, before, after = ev
        if n == 0 or len(kf_ticks) == 0:
            return
        deltas = np.einsum("kij,kjl->kil", after, np.linalg.inv(before)).astype(np.float32)
        j = np.clip(np.searchsorted(kf_ticks, np.arange(n), side="right") - 1, 0, None)
        d = torch.from_numpy(deltas[j]).to(fe.pose_hist.device)
        fe.pose_hist[:n] = d @ fe.pose_hist[:n]

    def _on_loop_closed(
        self, fe: Frontend, be: MapBackend, graph: dg.DeformGraph, rewrite_history: bool = True
    ) -> None:
        """Everything an accepted deformation touches beyond the map: the
        pose history and the fern keyframe poses go through the graph, then
        the map is re-partitioned.  `rewrite_history=False` when the sparse
        tracker's PGO already corrected the history this frame (the graph
        was built against the drifted layout: applying it too would apply
        the loop correction twice)."""
        fe.last_loop_graph = graph
        n = len(fe.ts_log)
        with timer.span("loop.rewrite_poses"):
            if n and rewrite_history:
                fe.pose_hist[:n] = dg.apply_to_poses(graph, fe.pose_hist[:n], fe.hist_times[:n])
            if fe.fern_state is not None:
                db = fe.fern_state.db
                fe.fern_state = fe.fern_state._replace(
                    db=db._replace(poses=dg.apply_to_poses(graph, db.poses, db.times))
                )
        with timer.span("loop.compact"):
            self._compact_now(be)

    def map_of(self, map_name: str) -> sm.SurfelMap:
        be = self.maps[map_name]
        return sm.SurfelMap(data=be.map_data, count=be.map_count)

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
        `depth_raw` [H,W] are numpy arrays or tensors; `depth_raw=None`
        takes depth from the attached depth CNN (`predict_depth`).
        `in_pose` (camera-to-world) bypasses tracking (ground-truth
        injection).  With `sync=False` the stats are only logged and an
        empty dict returns.  The frame's spans carry the session tick it
        starts at as their frame id."""
        timer.set_frame(self.global_tick)
        with timer.span("frame"):
            return self._frame(name, rgb, depth_raw, timestamp, in_pose, sync, cluster)

    def _frame(self, name, rgb, depth_raw, timestamp, in_pose, sync, cluster):
        fe = self.frontends[name]
        t0 = self.timer.tick("frame_dispatch")
        cfg = self.config
        dev = self.device
        with timer.span("frame.upload"):
            rgb = torch.as_tensor(rgb, device=dev)
            if depth_raw is not None:
                depth_raw = torch.as_tensor(depth_raw, device=dev).to(torch.float32)
            use_in = in_pose is not None
            if use_in:
                pose_in = torch.as_tensor(np.asarray(in_pose, np.float32), device=dev)
            else:
                pose_in = torch.eye(4, dtype=torch.float32, device=dev)
        if depth_raw is None:
            # monocular: the depth CNN supplies depth BEFORE tracking
            if not (cfg.predict_depth and self._depth_predictor is not None):
                raise ValueError(
                    "no depth given and no depth predictor attached "
                    "(set predict_depth=True and call set_depth_predictor)"
                )
            with timer.span("frame.depth_cnn", device=dev.type == "cuda"):
                depth_raw = self._depth_predictor.predict(rgb).to(dev, torch.float32)
        if cfg.orb_tracking and not use_in:
            # the sparse tracker supplies the pose: device values, consumed
            # by the step without a host branch
            pose_in, use_in = self._track_sparse(fe, rgb, depth_raw)
        be = self.backend_of(name)
        # install the backend's canonical map and the session tick
        fe.state = fe.state.replace(
            map_data=be.map_data, map_count=be.map_count,
            tick=torch.full((), self.global_tick, dtype=torch.int64, device=dev),
        )
        with timer.span("frame.dense_step"):
            fe.state, stats = fe.step_fn(
                fe.state, rgb, depth_raw, pose_in, use_in, cfg.fusion_weight_multiplier,
                float(cluster),
            )
        # on the card the stats row is the graph's buffer, which the next
        # replay overwrites
        stats = stats.clone()
        self._set_map(be, fe.state.map_data, fe.state.map_count)
        fe.record_pose(stats, self.global_tick)
        self.global_tick += 1
        fe.ts_log.append(timestamp)
        fe.stats_log.append(stats)
        fe.tick += 1
        with timer.span("frame.pace"):
            self._pace(fe)
        if cfg.relocalisation and dev.type == "cuda":
            self._queue_bad_count(fe, stats)
        self.timer.tock("frame_dispatch", t0)
        if fe.tick % self._compact_interval == 0:
            # reclaims culled slots and re-partitions [inactive..., active...]
            with timer.span("frame.compact"):
                self._compact_now(be)
        # lost-tracking state machine: the bad-frame counter lives on the
        # device; poll it at the loop-check cadence from a frame two cadences
        # back (long finished, so the read does not drain the queue), or
        # every frame once lost
        if cfg.relocalisation and (fe.tick % cfg.loop_check_interval == 0 or fe.lost):
            lag = 0 if fe.lost else 2 * cfg.loop_check_interval
            if lag and dev.type == "cuda":
                # frame t-lag's count, in pinned memory behind its event:
                # the read waits for that frame alone, not the stream
                ev, host = fe.bad_counts[0]
                ev.synchronize()
                fe.consecutive_bad = int(host)
            else:
                row = fe.stats_log[max(len(fe.stats_log) - 1 - lag, 0)]
                fe.consecutive_bad = int(row[stepmod.STAT_CONSEC_BAD])
            fe.lost = fe.consecutive_bad > 10
            if fe.lost and self.relocalise(name, rgb, depth_raw):
                fe.lost = False
                fe.consecutive_bad = 0
                fe.state = fe.state.replace(consec_bad=torch.zeros_like(fe.state.consec_bad))
        # loop closure / place recognition at the loop-check cadence
        if not cfg.open_loop and fe.tick % cfg.loop_check_interval == 0 and fe.tick > 2:
            if fe.fern_state is None:
                fe.fern_state = loopsmod.make_fern_state(fe.camera, cfg, device=dev)
            tracking_healthy = not (cfg.relocalisation and (fe.lost or fe.consecutive_bad > 0))
            if tracking_healthy:
                with timer.span("loop.ferns"):
                    fe.fern_state, _, _, _ = loopsmod.update_ferns(
                        fe.fern_state, rgb, depth_raw / cfg.depth_factor,
                        preprocess.rgb_to_intensity(rgb), fe.state.pose,
                        # the session tick: the surfel / deformation-node timeline
                        self.global_tick, cfg.fern_thresh,
                        factor=loopsmod.fern_factor(cfg), max_capacity=cfg.fern_db_max,
                    )
            if self.global_tick > cfg.time_delta and tracking_healthy:
                fe.loop_checks += 1
                with timer.span("loop.check"):
                    fe.state, linfo, lgraph, be.rel_bank = loopsmod.try_local_loop(
                        fe.state, fe.camera, cfg, rel_bank=be.get_rel_bank()
                    )
                self._set_map(be, fe.state.map_data, fe.state.map_count)
                fe.last_loop_info = linfo
                if linfo.closed:
                    fe.loops_closed += 1
                    be.deforms += 1
                    self._on_loop_closed(fe, be, lgraph)
            # inter-map: another map's ferns may recognise this view
            if tracking_healthy and len(self.maps) > 1:
                with timer.span("loop.intermap"):
                    self._try_intermap(fe, rgb, depth_raw)
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

    def _pace(self, fe: Frontend) -> None:
        """Bounded pacing (`densemonoslam_tpu/engine.py:502-509`): every 4
        frames, once more than `_PACING_LAG` stats rows are logged, wait for
        the work of the frame `_PACING_LAG` rows back, and only for it.  In
        steady state that frame has long finished; when the device falls
        behind, the wait holds the host's queue to about that many frames.
        On the CPU the work is done when the call returns: nothing to wait
        for."""
        global PACING_WAITS
        dev = fe.state.map_data.device
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            fe.frame_events.append(ev)
        if fe.tick % 4 == 0 and len(fe.stats_log) > _PACING_LAG:
            PACING_WAITS += 1
            if len(fe.frame_events) == _PACING_LAG:
                fe.frame_events[0].synchronize()

    def _queue_bad_count(self, fe: Frontend, stats: torch.Tensor) -> None:
        """Copy this frame's bad-frame count into pinned memory behind an
        event, for the poll `2 * loop_check_interval` frames later (the
        deque's oldest entry is that frame's, or frame 0's before then)."""
        keep = 2 * self.config.loop_check_interval + 1
        if fe.bad_counts is None or fe.bad_counts.maxlen != keep:
            fe.bad_counts = collections.deque(maxlen=keep)
        host = torch.empty((), dtype=torch.float32, pin_memory=True)
        host.copy_(stats[stepmod.STAT_CONSEC_BAD], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(stats.device))
        fe.bad_counts.append((ev, host))

    def _track_sparse(self, fe: Frontend, rgb: torch.Tensor, depth_raw: torch.Tensor):
        """The `orb_tracking` branch: track the frame with the frontend's
        sparse tracker (created on first use), rewrite the pose history after
        a pose-graph optimisation, and with `hybrid_loops` close the dense map
        on the tracker's loop pair.  Returns (pose, ok) as device values."""
        cfg = self.config
        if fe.sparse_tracker is None:
            fe.sparse_tracker = SparseTracker(fe.camera.intrinsics, device=self.device)
            fe.sparse_tracker.pose = fe.pose
        with timer.span("frame.sparse_track"):
            pose, ok = fe.sparse_tracker.track(
                preprocess.rgb_to_intensity(rgb), depth_raw / cfg.depth_factor
            )
        ev = fe.sparse_tracker.pop_pgo_event()
        if ev is not None:
            # a sparse loop closed and the pose graph was re-optimised: the
            # dense trajectory takes the per-keyframe corrections (the map's
            # correction is the hybrid closure's job below)
            self._rewrite_history_from_pgo(fe, ev)
        if cfg.hybrid_loops:
            pair = fe.sparse_tracker.pop_loop()
            if pair is not None:
                pose_est, pose_corr = pair
                C = (pose_corr @ np.linalg.inv(pose_est)).astype(np.float32)
                be = self.backend_of(fe.name)
                fe.state = fe.state.replace(map_data=be.map_data, map_count=be.map_count)
                fe.loop_checks += 1
                fe.state, linfo, lgraph = loopsmod.apply_hybrid_loop(
                    fe.state, C, fe.camera, cfg, rel_bank=be.get_rel_bank()
                )
                self._set_map(be, fe.state.map_data, fe.state.map_count)
                fe.last_loop_info = linfo
                if linfo.closed:
                    fe.loops_closed += 1
                    fe.sparse_tracker.pose = fe.pose
                    self._on_loop_closed(fe, be, lgraph, rewrite_history=ev is None)
        return pose, ok

    def relocalise(self, name: str, rgb, depth_raw) -> bool:
        """Fern relocalisation: query the fern DB with the current frame,
        photometric-check the candidate, then verify it geometrically
        (`loops.verify_recovery`); the accepted pose is the ICP-refined one."""
        fe = self.frontends[name]
        if fe.fern_state is None:
            return False
        cfg = self.config
        dev = self.device
        rgb = torch.as_tensor(rgb, device=dev)
        depth_m = torch.as_tensor(depth_raw, device=dev).to(torch.float32) / cfg.depth_factor
        ff = loopsmod.fern_factor(cfg)
        db = fe.fern_state.db
        rgb8 = fernmod.downsample_for_ferns(rgb.to(torch.float32), ff)
        d8 = fernmod.downsample_for_ferns(depth_m, ff)
        code = fernmod.encode(fe.fern_state.coder, rgb8, d8)
        idx, dis = fernmod.best_match(db, code)
        idx = idx.reshape(1)  # index_select: a 0-dim index would be read on the host
        i8 = 0.299 * rgb8[..., 0] + 0.587 * rgb8[..., 1] + 0.114 * rgb8[..., 2]
        photo = fernmod.photometric_check(
            db.intensity.index_select(0, idx)[0], i8, db.depth.index_select(0, idx)[0], d8
        )
        # one read of the three gates
        n_db, dis, photo = torch.stack([db.count.to(torch.float32), dis, photo]).tolist()
        if n_db == 0 or dis > 0.9 or photo > cfg.photo_thresh:
            return False
        be = self.backend_of(name)
        frame_pyr = odometry.build_frame_pyramid(
            rgb, depth_m, fe.camera.intrinsics, cfg.pyramid_levels
        )
        pose, ok, _info = loopsmod.verify_recovery(
            frame_pyr, db.poses.index_select(0, idx)[0], be.map_data, be.map_count, fe.camera, cfg
        )
        if not ok:
            return False
        fe.state = fe.state.replace(
            pose=torch.as_tensor(pose, device=dev),
            model_age=torch.full_like(fe.state.model_age, stepmod.MODEL_INVALID_AGE),
        )
        return True

    def _try_intermap(self, fe: Frontend, rgb: torch.Tensor, depth_raw: torch.Tensor) -> None:
        """Try to localise this camera in another map and merge the maps on
        success (reference `resolveRelativeTransformationFern`, then
        `consumeReferenceFrame`): each other map with a fern DB is queried
        with this view's code, and the first one that verifies is merged
        into (this camera's map moves into its frame).  The view's code and
        pyramid are built only when some other map has a fern DB."""
        cfg = self.config
        if fe.fern_state is None:
            return
        others = []
        for other_name, other_be in self.maps.items():
            if other_name == fe.map_name:
                continue
            other_fe = next(
                (self.frontends[n] for n in other_be.contexts
                 if self.frontends[n].fern_state is not None), None,
            )
            if other_fe is not None:
                others.append((other_name, other_be, other_fe))
        if not others:
            return
        depth_m = depth_raw / cfg.depth_factor
        ff = loopsmod.fern_factor(cfg)
        code = fernmod.encode(
            fe.fern_state.coder, fernmod.downsample_for_ferns(rgb.to(torch.float32), ff),
            fernmod.downsample_for_ferns(depth_m, ff),
        )
        frame_pyr = odometry.build_frame_pyramid(
            rgb, depth_m, fe.camera.intrinsics, cfg.pyramid_levels
        )
        for other_name, other_be, other_fe in others:
            fe.intermap_checks += 1
            pose_in_b, ok, _info = loopsmod.resolve_intermap(
                frame_pyr, code, other_fe.fern_state.db, other_be.map_data,
                other_be.map_count, fe.camera, cfg,
            )
            if ok:
                fe.intermap_merges += 1
                # T maps this camera's map coordinates into the other map's
                self.merge_into(fe.map_name, other_name, pose_in_b @ np.linalg.inv(fe.pose))
                return

    def batch_align(
        self, name_a: str, name_b: str, merge: bool = False,
        min_inliers: int = 30, max_rms: float = 0.25,
    ):
        """Initialisation-free alignment of camera `name_a`'s map onto camera
        `name_b`'s (the reference GUI's "Batch Align", FGR's role): ORB
        correspondences between the two cameras' current predicted views,
        each backprojected with its own camera's intrinsics, then the
        graduated-non-convexity rigid solve
        (`registration.global_registration`).

        Returns (T_ab world transform of map a into map b [4,4] numpy,
        inliers, rms), or None when the solve fails the gates.  With
        `merge=True` an accepted alignment merges the maps (`merge_into`)."""
        fa, fb = self.frontends[name_a], self.frontends[name_b]
        T_cam, inl, rms = registration.global_registration(
            fa.state.pred_intensity, fa.state.pred_depth,
            fb.state.pred_intensity, fb.state.pred_depth,
            fa.camera.intrinsics, fb.camera.intrinsics,
        )
        if inl < min_inliers or rms > max_rms:
            return None
        # camera a -> camera b, lifted to the worlds: pose_b @ T_cam @ pose_a^-1
        T_ab = (fb.pose @ T_cam.cpu().numpy() @ np.linalg.inv(fa.pose)).astype(np.float32)
        if merge and fa.map_name != fb.map_name:
            self.merge_into(fa.map_name, fb.map_name, T_ab)
        return T_ab, int(inl), float(rms)

    def merge_into(self, src_map: str, dst_map: str, T_ab: np.ndarray) -> None:
        """Merge map `src_map` into `dst_map` with world transform `T_ab`
        (reference `consumeReferenceFrame`): the surfels (then a compaction
        of the merged map), the carried constraints, and every member
        camera's pose, keyframe pose, pose history and fern keyframes move
        into the destination's frame; the source map goes away."""
        cfg = self.config
        src, dst = self.maps[src_map], self.maps[dst_map]
        T = torch.as_tensor(np.asarray(T_ab, np.float32), device=self.device)
        with timer.span("merge.maps"):
            data, count, dropped = loopsmod.merge_maps(
                dst.map_data, dst.map_count, src.map_data, src.map_count, T
            )
            dst.dropped += dropped  # overflow is surfaced, not silent
        with timer.span("merge.compact"):
            # merge_maps does not re-sort: restore the [inactive..., active...]
            # partition before the windowed passes read the merged map
            m = sm.compact(
                sm.SurfelMap(data=data, count=count), time=float(self.global_tick),
                time_delta=cfg.time_delta, max_active=self._max_active(),
            )
        with timer.span("merge.members"):
            if src.rel_bank is not None:
                dst.rel_bank = loopsmod.merge_rel_banks(dst.get_rel_bank(), src.rel_bank, T)
            dst_fe = self.frontends[dst.contexts[0]]
            for name in src.contexts:
                f = self.frontends[name]
                f.state = f.state.replace(
                    pose=T @ f.state.pose, kf_pose=T @ f.state.kf_pose,
                    model_age=torch.full_like(f.state.model_age, stepmod.MODEL_INVALID_AGE),
                )
                n = len(f.ts_log)
                if n:
                    # the whole trajectory moves into the destination's frame
                    f.pose_hist[:n] = T @ f.pose_hist[:n]
                if f.fern_state is not None and dst_fe.fern_state is not None:
                    dst_fe.fern_state = dst_fe.fern_state._replace(
                        db=loopsmod.consume_ferns(dst_fe.fern_state.db, f.fern_state.db, T)
                    )
                f.map_name = dst_map
            dst.contexts.extend(src.contexts)
            del self.maps[src_map]
            self._set_map(dst, m.data, m.count)
            if self.device.type == "cuda":
                # their graphs hold the source map: capture them over this one
                for name in src.contexts:
                    self._recompile(self.frontends[name])

    # ------------------------------------------------------------- exports
    def predict_view(self, name: str, mode: int = splat.MODE_ALL) -> splat.Prediction:
        """Render camera `name`'s map at its current pose."""
        fe = self.frontends[name]
        res = fe.camera.resolution
        m = self.map_of(fe.map_name)
        return splat.render(
            m.data, m.count, fe.state.pose, fe.camera.intrinsics, res.width, res.height,
            time=float(fe.tick), time_delta=self.config.time_delta, mode=mode,
        )

    def view_images(self, name: str) -> Dict[str, np.ndarray]:
        """The predicted view at camera `name`'s pose as uint8 images:
        colour, depth scaled by its maximum, and normals mapped to 0..255."""
        pred = self.predict_view(name)
        depth = pred.depth
        d_vis = depth / torch.clamp(depth.max(), min=1e-6) * 255.0
        imgs = {
            "rgb": torch.clamp(pred.color, 0, 255),
            "depth": torch.clamp(d_vis, 0, 255),
            "normals": (pred.nmap * 0.5 + 0.5) * 255,
        }
        return {k: v.to(torch.uint8).cpu().numpy() for k, v in imgs.items()}

    def save_view_images(self, name: str, out_dir: str, prefix: str = "view") -> None:
        """Write the predicted RGB / depth / normal images at the current pose
        as `<prefix>_{rgb,depth,normals}.png` (the headless substitute for the
        reference GUI's image dumps)."""
        import os

        from densemonoslam_tpu_torch.io.writers import png_bytes

        os.makedirs(out_dir, exist_ok=True)
        for kind, img in self.view_images(name).items():
            with open(os.path.join(out_dir, f"{prefix}_{kind}.png"), "wb") as f:
                f.write(png_bytes(img))

    def stage_ms(self, name: str) -> Dict[str, List[Tuple[int, float]]]:
        """Device milliseconds of camera `name`'s step stages per frame, from
        the stamps its current step took (`step.stage_ms`: ``track``,
        ``render``, ``fuse``, ``step``, each a list of (session tick, ms));
        one copy of the stamp ring to the host.  On the CPU, host
        milliseconds."""
        return stepmod.stage_ms(self._stages.get(name))

    def save_times(self, path: str) -> None:
        self.timer.write_csv(path)

    def save_checkpoint(self, name: str, path: str) -> None:
        from densemonoslam_tpu_torch.utils.checkpoint import save_frontend

        fe = self.frontends[name]
        be = self.backend_of(name)
        fe.state = fe.state.replace(map_data=be.map_data, map_count=be.map_count)
        save_frontend(path, fe)

    def load_checkpoint(self, name: str, path: str) -> None:
        """Restore camera `name` from a checkpoint (of either package); the
        session tick moves up to the restored frontend's."""
        from densemonoslam_tpu_torch.utils.checkpoint import load_frontend

        fe = self.frontends[name]
        load_frontend(path, fe)
        self._set_map(self.backend_of(name), fe.state.map_data, fe.state.map_count)
        self.global_tick = max(self.global_tick, fe.tick)

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
