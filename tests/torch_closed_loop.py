"""The closed-loop scenario of the PyTorch port's engine that
`tests/test_torch_loops_engine.py` runs on the CPU and `chip_smoke.py` runs
on the card: the synthetic orbit at 160x120, frame 0 at its true pose,
frames 1-9 tracked, the first epoch aged out, then frames 0-9 fed again with
a drift until a loop closes.  It imports nothing of the JAX package."""

import os

import numpy as np

from densemonoslam_tpu_torch import engine as engmod
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence

CLOSED = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=False, loop_check_interval=5, time_delta=50, deform_graph_sample_rate=600,
    max_deform_nodes=128, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
    confidence_threshold=1.0,
)
DRIFT = np.array([0.08, 0.0, 0.0], np.float32)


def history_run(out_dir: str, tag: str, flush_every_frame: bool, device: str) -> dict:
    """The scenario on `device`.  With `flush_every_frame` the pose history
    is read after every frame, which lands each frame's pose as it comes.
    The checkpoint is written to `out_dir/<tag>.npz`.  Returns the
    trajectory, the history's ticks, the checkpoint's arrays, the history
    writes of each frame and the frames processed."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    eng = Engine(seq.camera, EngineConfig(**CLOSED), device=device)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    writes = []

    def frame(i, t, pose=None):
        before = engmod.HIST_WRITES
        eng.process_frame("cam0", *seq.frame(i), t, in_pose=pose)
        if flush_every_frame:
            _ = fe.pose_hist  # a read lands the queue
        writes.append(engmod.HIST_WRITES - before)

    frame(0, 0.0, seq.gt_pose(0).astype(np.float32))
    for i in range(1, 10):
        frame(i, float(i))
    eng.global_tick = 100
    for i in range(10):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += DRIFT
        frame(i, float(100 + i), pose)
        if fe.loops_closed:
            break
    if fe.loops_closed < 1:
        raise AssertionError(f"history run ({tag}): no loop closed: {fe.last_loop_info}")
    path = os.path.join(out_dir, f"{tag}.npz")
    eng.save_checkpoint("cam0", path)
    with np.load(path) as z:
        ckpt = {k: z[k] for k in z.files}
    return dict(traj=np.stack([p for _, p in fe.trajectory]),
                ticks=fe.hist_times[: len(fe.ts_log)].cpu().numpy(), ckpt=ckpt, writes=writes,
                n=len(fe.ts_log))
