"""Inter-map merges of the PyTorch port held against the benchmark's plain
reference (`benchmark/reference/merge.py`), on the CPU: `Engine.merge_into`
(the rows, the compaction, every member camera's poses and history, the
fern keyframes) on seeded random maps and rigid transforms of any
rotation, `loops.resolve_intermap` and `loops.verify_recovery` at
160x120, and a two-camera session through `Engine.process_frame` whose
second camera joins late and is merged.  The card's own case (the
`step.capture` span) is marked `cuda`."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import ferns as tferns
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.tracking import odometry as todo
from densemonoslam_tpu_torch.utils import timer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))

from reference import config as rconfig  # noqa: E402
from reference import merge as rmerge  # noqa: E402

torch.set_num_threads(2)

CAMERA = CameraConfig(FrameResolution(160, 120), CameraIntrinsics(132.0, 132.0, 79.5, 59.5), "c")
# the benchmark's tiny RGB-D configuration: loose loop gates, so that a
# short CPU run verifies and merges
TINY = dict(max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=True,
            nid_threshold=0.85, pyramid_levels=3, track_row_stride=1, open_loop=False,
            loop_check_interval=8, time_delta=30, deform_graph_sample_rate=2000,
            max_deform_nodes=256, loop_min_inactive_frac=0.01, loop_cons_err_thresh=1.0,
            loop_inlier_frac=0.0, icp_count_thresh=0, loop_icp_err_thresh=1.0, cov_thresh=1.0)


def _rigid(rng, max_angle: float = np.pi) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(0.0, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    T[:3, 3] = rng.normal(0, 1, 3)
    return T.astype(np.float32)


def _rows(rng, n: int, cap: int, t_now: float) -> torch.Tensor:
    """A map of `cap` rows with `n` below its count: a fifth of them dead,
    last seen over the ticks around `t_now` (so the compaction has both an
    inactive and an active part)."""
    data = np.zeros((cap + 1, 16), np.float32)
    data[:n, sm.POS] = rng.normal(0, 1, (n, 3))
    nrm = rng.normal(0, 1, (n, 3))
    data[:n, sm.NORMAL] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    data[:n, sm.CONF] = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(1, 9, n))
    data[:n, sm.COLOR] = rng.uniform(0, 255, (n, 3))
    data[:n, sm.RADIUS] = rng.uniform(0.001, 0.01, n)
    data[:n, sm.INIT_TIME] = rng.integers(0, int(t_now), n)
    data[:n, sm.LAST_SEEN] = rng.integers(0, int(t_now), (n, 3))
    return torch.from_numpy(data)


def _fill_ferns(fe, rng, count: int) -> None:
    db = fe.fern_state.db
    poses = torch.from_numpy(np.stack([_rigid(rng) for _ in range(count)]))
    db.poses[:count] = poses
    fe.fern_state = fe.fern_state._replace(db=db._replace(count=torch.tensor(count)))


@pytest.mark.parametrize("cb,ca", [(0, 500), (1200, 700), (3500, 900)],
                         ids=["into_empty", "fits", "overflow"])
def test_merge_into_matches_the_plain_merge(cb, ca):
    """Map A into map B with a random rigid transform: the merged map's
    rows (moved, appended, compacted) and the dropped count, each moved
    camera's pose, keyframe pose and pose history, and A's fern keyframes
    in B's database equal the plain reference's."""
    rng = np.random.default_rng(1000 * cb + ca)
    cap, t_now = 4096, 100.0
    cfg = EngineConfig(max_surfels=cap, time_delta=30, active_window=1024)
    eng = Engine(CAMERA, cfg, device="cpu")
    fa, fb = eng.frontend("camA"), eng.frontend("camB")
    eng.global_tick = int(t_now)
    data_a, data_b = _rows(rng, ca, cap, t_now), _rows(rng, cb, cap, t_now)
    eng._set_map(eng.maps["camA"], data_a.clone(), torch.tensor(ca))
    eng._set_map(eng.maps["camB"], data_b.clone(), torch.tensor(cb))
    n_hist = 37
    fa.pose, fa.state = _rigid(rng), fa.state.replace(kf_pose=torch.from_numpy(_rigid(rng)))
    fa.ts_log = [float(i) for i in range(n_hist)]
    fa.pose_hist = torch.from_numpy(np.stack([_rigid(rng) for _ in range(n_hist)]))
    fa.hist_times = torch.arange(n_hist, dtype=torch.float32)
    for fe, n in ((fa, 5), (fb, 3)):
        fe.fern_state = tloops.make_fern_state(CAMERA, cfg, capacity=16, device="cpu")
        _fill_ferns(fe, rng, n)
    before = {"pose": fa.state.pose.clone(), "kf_pose": fa.state.kf_pose.clone(),
              "hist": fa.pose_hist[:n_hist].clone(), "ferns": fa.fern_state.db.poses[:5].clone()}
    T = _rigid(rng)

    eng.merge_into("camA", "camB", T)

    assert list(eng.maps) == ["camB"] and fa.map_name == "camB"
    max_active = cfg.active_window if cfg.active_window < cfg.max_surfels else 0
    want, dropped = rmerge.merge_maps(data_b[:cb], data_a[:ca], cap, torch.from_numpy(T),
                                      t_now, cfg.time_delta, max_active)
    be = eng.maps["camB"]
    n = int(be.map_count)
    assert n == want.shape[0] and be.dropped == dropped
    if cb == 3500:
        assert dropped > 0 and n <= cap - 1
    # one f32 rigid transform of unit-scale rows, the same formula: a few ulps
    torch.testing.assert_close(be.map_data[:n], want, rtol=0, atol=2e-6)
    assert fa.state.map_data is be.map_data is fb.state.map_data
    Tt = torch.from_numpy(T)
    torch.testing.assert_close(fa.state.pose, rmerge.move_poses(Tt, before["pose"]), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(fa.state.kf_pose, rmerge.move_poses(Tt, before["kf_pose"]),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(fa.pose_hist[:n_hist], rmerge.move_poses(Tt, before["hist"]),
                               rtol=0, atol=1e-5)
    db = fb.fern_state.db
    assert int(db.count) == 8
    torch.testing.assert_close(db.poses[3:8], rmerge.move_poses(Tt, before["ferns"]), rtol=0,
                               atol=1e-5)
    # the transform applied the wrong way round is far from it
    wrong = rmerge.move_poses(torch.linalg.inv(Tt), before["pose"])
    assert float((fa.state.pose - wrong).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(camera=CAMERA, num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def cam0_map(seq):
    """One camera's map and fern database after 40 frames of the lap."""
    eng = Engine(CAMERA, EngineConfig(**TINY), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(40):
        eng.process_frame("cam0", *seq.frame(i), float(i), sync=False)
    assert int(fe.fern_state.db.count) >= 3
    return eng, fe


def _plain_config() -> rconfig.EngineConfig:
    return rconfig.EngineConfig(**TINY)


def _plain_intr() -> rconfig.CameraIntrinsics:
    i = CAMERA.intrinsics
    return rconfig.CameraIntrinsics(i.fx, i.fy, i.cx, i.cy)


@pytest.mark.parametrize("lap_frame,candidate", [(30, None), (24, None), (28, 7)],
                         ids=["on_a_keyframe", "a_frame_away", "far_candidate"])
def test_verification_matches_the_plain_verification(seq, cam0_map, lap_frame, candidate):
    """The view of `lap_frame` localised in camera 0's map: where the fern
    query picks the candidate, `loops.resolve_intermap`; where it is given
    (a keyframe far from the view), `loops.verify_recovery`.  The decision
    and the pose in the map equal the plain verification's."""
    eng, fe = cam0_map
    cfg = eng.config
    be = eng.maps["cam0"]
    rgb, depth = seq.frame(lap_frame)
    rgb_t, depth_t = torch.from_numpy(rgb), torch.from_numpy(depth)
    pyr = todo.build_frame_pyramid(rgb_t, depth_t, CAMERA.intrinsics, cfg.pyramid_levels)
    db = fe.fern_state.db
    if candidate is None:
        ff = tloops.fern_factor(cfg)
        code = tferns.encode(fe.fern_state.coder,
                             tferns.downsample_for_ferns(rgb_t.float(), ff),
                             tferns.downsample_for_ferns(depth_t, ff))
        idx, dis = tferns.best_match(db, code)
        pose, ok, _ = tloops.resolve_intermap(pyr, code, db, be.map_data, be.map_count, CAMERA,
                                              cfg)
        cand = db.poses[int(idx)]
        if float(dis) > 0.45:
            pytest.fail(f"the fern query missed the lap's keyframes (dissimilarity {float(dis)})")
    else:
        cand = torch.from_numpy(seq.gt_pose(candidate).astype(np.float32))
        pose, ok, _ = tloops.verify_recovery(pyr, cand, be.map_data, be.map_count, CAMERA, cfg)
    n = int(be.map_count)
    want, info = rmerge.verify(rgb_t, depth_t, cand, be.map_data[:n], be.map_data.shape[0] - 1,
                               _plain_config(), _plain_intr(), 160, 120)
    assert ok == (want is not None), info
    assert ok == (candidate is None)
    if ok:
        np.testing.assert_allclose(pose, want.numpy(), rtol=0, atol=1e-5)
        # it is a pose of the lap frame's view
        assert np.abs(pose - seq.gt_pose(lap_frame)).max() < 0.02


def test_a_camera_that_joins_late_is_merged(seq, monkeypatch):
    """Camera 1 starts at lap frame 23 and joins at tick 47; at its first
    loop check it is found in camera 0's map: the maps go 2 -> 1, camera
    1's trajectory, pose and fern keyframes move by the found `T_ab`, the
    counters count the query and the merge, and the merge's spans carry
    camera 1's frame."""
    eng = Engine(CAMERA, EngineConfig(**TINY), device="cpu")
    f0, f1 = eng.frontend("cam0"), eng.frontend("cam1")
    f0.pose = seq.gt_pose(0).astype(np.float32)
    f1.pose = seq.gt_pose(23).astype(np.float32)
    seen = []
    real = eng.merge_into

    def merge_into(src, dst, T):
        seen.append({"src": src, "dst": dst, "T": np.array(T), "tick": eng.global_tick,
                     "hist": f1.pose_hist[:len(f1.ts_log)].clone(), "pose": f1.state.pose.clone(),
                     "ferns": f1.fern_state.db.poses[: int(f1.fern_state.db.count)].clone(),
                     "cb": int(f0.fern_state.db.count)})
        return real(src, dst, T)

    monkeypatch.setattr(eng, "merge_into", merge_into)
    timer.reset()
    timer.enable()
    try:
        maps = []
        for t in range(62):
            eng.process_frame("cam0", *seq.frame(t % 40), float(t), sync=False)
            if t >= 47:
                j = t - 47
                eng.process_frame("cam1", *seq.frame((23 + j) % 40), float(j), sync=False)
            maps.append(len(eng.maps))
        recs = timer.spans()
    finally:
        timer.enable(False)
        timer.reset()
    assert maps[0] == 2 and maps[-1] == 1 and len(seen) == 1
    m = seen[0]
    assert (m["src"], m["dst"]) == ("cam1", "cam0") and f1.map_name == "cam0"
    assert (f1.intermap_checks, f1.intermap_merges) == (1, 1)
    assert f0.intermap_merges == 0
    T = torch.from_numpy(m["T"].astype(np.float32))
    n = m["hist"].shape[0]
    torch.testing.assert_close(f1.pose_hist[:n], rmerge.move_poses(T, m["hist"]), rtol=0, atol=1e-5)
    assert np.allclose(f1.trajectory[0][1], (T @ m["hist"][0]).numpy(), atol=1e-5)
    torch.testing.assert_close(f0.fern_state.db.poses[m["cb"]: m["cb"] + m["ferns"].shape[0]],
                               rmerge.move_poses(T, m["ferns"]), rtol=0, atol=1e-5)
    merge = [r for r in recs if r.name.startswith("merge.")]
    assert [r.name for r in merge] == ["merge.maps", "merge.compact", "merge.members"]
    assert {r.frame for r in merge} == {m["tick"] - 1}
    query = [r for r in recs if r.name == "loop.intermap" and r.frame == m["tick"] - 1]
    assert len(query) == 1 and all(query[0].start_ns <= r.start_ns <= query[0].end_ns
                                   for r in merge)
    # both cameras go on in the one map
    assert np.isfinite(f0.pose).all() and np.isfinite(f1.pose).all()
    assert f0.state.map_data is f1.state.map_data is eng.maps["cam0"].map_data


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the step is a CUDA graph only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_step_capture_is_a_span_keyed_by_its_frame(cuda, seq):
    """On the card a camera's first frame captures its step: one
    `step.capture` span inside that frame's `frame.dense_step`, with the
    frame's id; later frames replay and capture nothing."""
    eng = Engine(CAMERA, EngineConfig(**TINY), device=cuda)
    eng.frontend("cam0").pose = seq.gt_pose(0).astype(np.float32)
    timer.reset()
    timer.enable()
    try:
        for i in range(3):
            eng.process_frame("cam0", *seq.frame(i), float(i), sync=False)
        torch.cuda.synchronize()
        recs = timer.spans()
    finally:
        timer.enable(False)
        timer.reset()
    caps = [r for r in recs if r.name == "step.capture"]
    assert len(caps) == 1 and caps[0].frame == 0
    assert recs[caps[0].parent].name == "frame.dense_step"
    assert recs[caps[0].parent].frame == 0
