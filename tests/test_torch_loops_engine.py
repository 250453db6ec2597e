"""Closed-loop runs of the PyTorch port's engine (CPU), held to the bounds of
the JAX package's tests on the same fixtures:
`tests/test_loops.py::test_loop_closure_corrects_whole_trajectory` and
`tests/test_reactivation.py::test_closure_keeps_active_set_inside_window`."""

import numpy as np
import torch

from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm

torch.set_num_threads(2)

CLOSED = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=False, loop_check_interval=5, time_delta=50, deform_graph_sample_rate=600,
    max_deform_nodes=128, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
    confidence_threshold=1.0,
)
DRIFT = np.array([0.08, 0.0, 0.0], np.float32)


def test_loop_closure_corrects_whole_trajectory(tmp_path):
    """An accepted closure rewrites the pose history, not just the current
    pose: trajectory error at least halves, the anchored first epoch stays
    within 2 cm, and `save_trajectory` writes the corrected poses."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    eng = Engine(seq.camera, EngineConfig(**CLOSED), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fed, gts = [], []
    for i in range(10):
        gt = seq.gt_pose(i).astype(np.float32)
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=gt)
        fed.append(gt)
        gts.append(gt)
    eng.global_tick = 100  # the first epoch becomes inactive
    for i in range(10):
        gt = seq.gt_pose(i).astype(np.float32)
        pose = gt.copy()
        pose[:3, 3] += DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
        fed.append(pose)
        gts.append(gt)
        if fe.loops_closed:
            break
    assert fe.loops_closed >= 1, fe.last_loop_info
    assert eng.backend_of("cam0").deforms == fe.loops_closed

    def traj_err(poses):
        t = np.stack([p[:3, 3] for p in poses])
        g = np.stack([p[:3, 3] for p in gts[: len(poses)]])
        return np.sqrt(np.mean(np.sum((t - g) ** 2, axis=1)))

    corrected = [p for _, p in fe.trajectory]
    assert traj_err(corrected) < 0.5 * traj_err(fed), (traj_err(corrected), traj_err(fed))
    for i in range(10):
        np.testing.assert_allclose(corrected[i][:3, 3], gts[i][:3, 3], atol=0.02)
    path = tmp_path / "traj.freiburg"
    eng.save_trajectory("cam0", str(path))
    rows = np.loadtxt(path)
    np.testing.assert_allclose(rows[-1, 1:4], corrected[-1][:3, 3], atol=1e-5)


def _active_overflow(state, t_now, time_delta, window):
    """(#active surfels, #active surfels OUTSIDE the streamed tail window)."""
    data = state.map_data.numpy()[:-1]
    count = int(state.map_count)
    idx = np.arange(data.shape[0])
    alive = (data[:, sm.CONF] > 0) & (idx < count)
    active = alive & (t_now - data[:, 12:15].max(axis=1) < time_delta)
    start = max(count - window, 0)
    return int(active.sum()), int((active & (idx < start)).sum())


def test_closure_keeps_active_set_inside_window():
    """More live surfels than `active_window`, then an accepted closure:
    every ACTIVE surfel stays inside the streamed tail window, and re-fusing
    the closure view matches the reactivated region instead of inserting it
    again."""
    window = 1 << 15
    cfg = EngineConfig(**CLOSED, active_window=window)
    seq = SyntheticSequence(num_frames=48, radius=0.6, max_angle=0.6)
    eng = Engine(seq.camera, cfg, device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(48):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    count = int(fe.state.map_count)
    live0 = int(np.sum(fe.state.map_data[:count, sm.CONF].numpy() > 0))
    assert live0 > window, f"fixture too small: {live0} live <= {window} window"

    eng.global_tick += 100  # age everything out, then revisit with a drift
    i_closed = None
    for i in range(10):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(148 + i), in_pose=pose)
        if fe.loops_closed:
            i_closed = i
            break
    assert fe.loops_closed >= 1, fe.last_loop_info
    n_active, overflow = _active_overflow(fe.state, eng.global_tick, cfg.time_delta, window)
    assert overflow == 0, (n_active, overflow)
    assert n_active <= window

    count_before = int(fe.state.map_count)
    eng.process_frame("cam0", *seq.frame(i_closed), 158.0,
                      in_pose=seq.gt_pose(i_closed).astype(np.float32))
    added = int(fe.state.map_count) - count_before
    assert added < 0.15 * 19200, f"re-fusing the reactivated view inserted {added} surfels"
    eng._compact_now(eng.backend_of("cam0"))
    n_active, overflow = _active_overflow(fe.state, eng.global_tick, cfg.time_delta, window)
    assert overflow == 0, (n_active, overflow)
