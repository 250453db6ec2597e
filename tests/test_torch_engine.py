"""The PyTorch port's `Engine` alone, held to the bounds of
`tests/test_engine.py` on the same synthetic fixture (open loop, always
fuse): ATE < 10 mm over 25 frames with > 10000 surfels, ATE < 8 mm over 15
frames, ground-truth injection ATE < 1e-6, and the exports; every mode of
the config runs a frame, a second frontend and RGB-only input without a
depth net raise, and the entry points default to the card."""

import numpy as np
import pytest
import torch

from densemonoslam_tpu_torch import cli
from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.eval import ate_rmse
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.io.writers import load_ply
from densemonoslam_tpu_torch.mapping.surfel_map import empty_map
from densemonoslam_tpu_torch.models.depthnet import DepthPredictor
from densemonoslam_tpu_torch.ops.warp import pixel_grid
from densemonoslam_tpu_torch.step import init_state
from densemonoslam_tpu_torch.tracking.sparse import SparseTracker

torch.set_num_threads(2)

BASE = dict(max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, open_loop=True,
            nid_keyframing=False)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


def _run_engine(seq, n_frames, use_gt_poses=False):
    eng = Engine(seq.camera, EngineConfig(**BASE), device="cpu")
    eng.frontend("cam0")
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    for i in range(n_frames):
        rgb, depth = seq.frame(i)
        in_pose = seq.gt_pose(i).astype(np.float32) if use_gt_poses else None
        info = eng.process_frame("cam0", rgb, depth, float(i), in_pose=in_pose)
        assert info["tracking_ok"] == 1.0, f"lost tracking at {i}"
    return eng


@pytest.fixture(scope="module")
def run25(seq):
    return _run_engine(seq, 25)


def _ate(eng, seq, n):
    est = [p for _, p in eng.frontends["cam0"].trajectory][:n]
    return ate_rmse(est, [seq.gt_pose(i) for i in range(n)])


def test_engine_slam_synthetic_ate(run25, seq):
    err = _ate(run25, seq, 25)
    assert err < 0.01, f"ATE {err * 1000:.1f} mm"
    assert run25.surfel_count("cam0") > 10000


def test_engine_first_15_frames_ate(run25, seq):
    """The engine is causal, so the first 15 poses of the 25-frame run are a
    15-frame run (`test_engine_frame_to_model_beats_frame_to_frame`)."""
    assert _ate(run25, seq, 15) < 0.008


def test_engine_gt_pose_injection(seq):
    eng = _run_engine(seq, 10, use_gt_poses=True)
    assert _ate(eng, seq, 10) < 1e-6


def test_engine_exports(run25, tmp_path):
    traj, ply, stats = tmp_path / "traj.freiburg", tmp_path / "map.ply", tmp_path / "run.stats"
    run25.save_trajectory("cam0", str(traj))
    n = run25.save_ply("cam0", str(ply), stable_only=False)
    run25.save_stats("cam0", str(stats))
    assert len(traj.read_text().splitlines()) == 25
    assert n > 1000
    p, _, _, _ = load_ply(str(ply))
    assert p.shape[0] == n and np.all(np.isfinite(p))
    assert len(stats.read_text().splitlines()) == 26  # 25 frames + summary


@pytest.mark.parametrize(
    "override",
    [dict(orb_tracking=True), dict(hybrid_loops=True), dict(predict_depth=True)],
    ids=["orb", "hybrid", "predict-depth"],
)
def test_engine_unported_modes_raise(seq, override):
    """The three monocular modes build on the CPU and run a frame (RGB
    only, with the packaged depth net attached, in the predict-depth
    case)."""
    eng = Engine(seq.camera, EngineConfig(**{**BASE, **override}), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    rgb, depth = seq.frame(0)
    if override.get("predict_depth"):
        eng.set_depth_predictor(DepthPredictor.pretrained_synthetic(device="cpu"))
        depth = None
    info = eng.process_frame("cam0", rgb, depth, 0.0)
    assert info["tracking_ok"] == 1.0 and info["surfels"] > 1000
    assert (fe.sparse_tracker is not None) == bool(override.get("orb_tracking"))


def test_engine_second_frontend_and_missing_depth_raise(seq):
    """A second frontend is a camera of its own, in a map of its own (the
    multi-camera path, `tests/test_torch_intermap.py`); RGB without depth
    and without a depth predictor raises."""
    eng = Engine(seq.camera, EngineConfig(**BASE), device="cpu")
    eng.frontend("cam0")
    fe1 = eng.frontend("cam1")
    assert fe1.sensor_id == 1 and fe1.map_name == "cam1" and eng.maps["cam1"].contexts == ["cam1"]
    rgb, _ = seq.frame(0)
    with pytest.raises(ValueError):  # RGB only, and no depth predictor attached
        eng.process_frame("cam0", rgb, None, 0.0)


@pytest.mark.parametrize(
    "make",
    [
        lambda: Engine(CameraConfig.tum_default(), EngineConfig(**BASE)),
        lambda: init_state(1 << 10, 12, 16),
        lambda: pixel_grid(12, 16),
        lambda: DepthPredictor.pretrained_synthetic(),
        lambda: SparseTracker(CameraConfig.tum_default().intrinsics),
        lambda: empty_map(1 << 10),
        lambda: cli.run(["--frames", "1"]),
    ],
    ids=["engine", "init_state", "pixel_grid", "depth_predictor", "sparse_tracker",
         "empty_map", "cli"],
)
def test_entry_points_default_to_cuda(make):
    """Without `device=` the entry points run on the card: with no card
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        make()
