"""Closed-loop runs of the PyTorch port's engine (CPU), held to the bounds of
the JAX package's tests on the same fixtures:
`tests/test_loops.py::test_loop_closure_corrects_whole_trajectory` and
`tests/test_reactivation.py::test_closure_keeps_active_set_inside_window`;
and the engine's batched pose history against a flush after every frame."""

import numpy as np
import torch

from densemonoslam_tpu_torch import engine as engmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from torch_closed_loop import CLOSED, DRIFT, history_run

torch.set_num_threads(2)


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


def test_batched_pose_history_matches_per_frame_flush(tmp_path):
    """The batched history gives the trajectory (tracked frames, injected
    frames and the loop closure's rewrite through the deformation graph),
    the history's ticks and every checkpoint array bit for bit as a flush
    after every frame; frames with no reader of the history write nothing
    to it, and a flush is one indexed write per history tensor."""
    batched = history_run(str(tmp_path), "batched", flush_every_frame=False, device="cpu")
    each = history_run(str(tmp_path), "each", flush_every_frame=True, device="cpu")
    assert batched["n"] == each["n"] > 10
    np.testing.assert_array_equal(batched["traj"], each["traj"])
    np.testing.assert_array_equal(batched["ticks"], each["ticks"])
    assert batched["ckpt"].keys() == each["ckpt"].keys()
    for k in batched["ckpt"]:
        np.testing.assert_array_equal(batched["ckpt"][k], each["ckpt"][k], err_msg=k)
    assert each["writes"] == [2] * each["n"]
    # only the loop-check frames read the history (the closure's rewrite)
    assert sum(batched["writes"]) < sum(each["writes"])
    assert set(batched["writes"]) <= {0, 2} and batched["writes"][:4] == [0, 0, 0, 0]


def test_record_pose_touches_no_tensor():
    """Between flushes `record_pose` only queues: the history tensors keep
    their storage and values and the write count stands still; the next
    read lands the queue in one write per tensor."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    eng = Engine(seq.camera, EngineConfig(max_surfels=1 << 16), device="cpu")
    fe = eng.frontend("cam0")
    eng.process_frame("cam0", *seq.frame(0), 0.0, in_pose=seq.gt_pose(0).astype(np.float32))
    hist, ticks = fe.pose_hist, fe.hist_times
    hist0, ticks0 = hist.clone(), ticks.clone()
    before = engmod.HIST_WRITES
    for k in range(1, 6):
        row = torch.arange(stepmod.N_STATS_TOTAL, dtype=torch.float32) + k
        fe.record_pose(row, 10 + k)
        fe.ts_log.append(float(k))
    assert engmod.HIST_WRITES == before
    assert fe._pose_hist_buf is hist and fe._hist_times_buf is ticks
    assert torch.equal(hist, hist0) and torch.equal(ticks, ticks0)
    assert fe.pose_hist is hist and engmod.HIST_WRITES == before + 2
    for k in range(1, 6):
        expect = torch.arange(stepmod.STAT_POSE0, stepmod.N_STATS_TOTAL, dtype=torch.float32) + k
        assert torch.equal(hist[k].reshape(-1), expect)
        assert float(ticks[k]) == 10 + k
