"""Camera managers of the PyTorch port (reference
`MultiCameraManagerFactory.h:13-45`): mirrors of the first four tests of
`tests/test_camera_manager.py` on the torch engine (CPU), and the round-robin
session held against the JAX package's on the same two logs."""

import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraConfig as JCamera
from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.config import FrameResolution as JRes
from densemonoslam_tpu.engine import Engine as JEngine
from densemonoslam_tpu.io import camera_manager as jcm
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.camera_manager import (
    MultiLogCameraManager, MultiMixedCameraManager, make_camera_manager, run_session,
)
from densemonoslam_tpu_torch.io.klg import write_klg
from densemonoslam_tpu_torch.io.stream import FrameReceiver, FrameSender, StreamCameraManager
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(2)

W, H = 96, 72
INTR = (79.2, 79.2, W / 2 - 0.5, H / 2 - 0.5)
CFG = dict(max_surfels=1 << 14, depth_cutoff=10.0, depth_factor=1.0, open_loop=True,
           nid_keyframing=False)


def _camera(name="cam"):
    return CameraConfig(FrameResolution(W, H), CameraIntrinsics(*INTR), name)


def _write_log(path, seq, start, n):
    frames = []
    for i in range(start, start + n):
        rgb, depth = seq.frame(i)
        frames.append((np.asarray(rgb), (np.asarray(depth) * 1000).astype(np.uint16), i))
    write_klg(str(path), frames)


@pytest.fixture(scope="module")
def two_logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    seq = SyntheticSequence(camera=_camera(), num_frames=16)
    a, b = d / "a.klg", d / "b.klg"
    _write_log(a, seq, 0, 6)
    _write_log(b, seq, 4, 6)  # overlapping territory
    return str(a), str(b)


def test_factory_selection(two_logs):
    a, b = two_logs
    mgr = make_camera_manager([a, b], W, H)
    assert isinstance(mgr, MultiLogCameraManager)
    assert mgr.cameras() == ["cam0", "cam1"]
    live = make_camera_manager([], W, H, live_port=0)
    assert isinstance(live, StreamCameraManager)
    live.receiver.close()
    mixed = make_camera_manager([a], W, H, n_sensors=2, live_port=0)
    assert isinstance(mixed, MultiMixedCameraManager)
    mixed.live.receiver.close()


def test_multilog_protocol(two_logs):
    a, _ = two_logs
    mgr = make_camera_manager([a], W, H)
    assert mgr.wait_for_cameras(1)
    rgb, depth, ts = mgr.get_next("cam0")
    assert rgb.shape == (H, W, 3) and depth.dtype == np.float32
    assert 0.1 < depth[depth > 0].mean() < 10.0  # metric, not millimetres
    n = 1
    while not mgr.finished("cam0"):
        assert mgr.get_next("cam0") is not None
        n += 1
    assert n == 6


# ROADMAP Queue 3, D5: from the same state, `odometry.track` of the two
# packages parts at camera 1's frame 4.  Its coarsest level (24x18) gives 26
# ICP inliers on the first Gauss-Newton iteration; the second iteration's
# step then differs by 0.26 m between the two f32 summation orders, and the
# frame lands 21-23 mm from the JAX pose (25.8 mm from the truth, where the
# JAX package is 4.4 mm off); the next frame comes back to 2 mm.
D5_FRAMES = {("cam1", 4): 0.03, ("cam1", 5): 0.005}


def test_run_session_two_cameras_matches_reference(two_logs):
    """Mirror of `test_run_session_two_cameras`, beside the JAX package's
    `run_session` over the same two logs: the same frames per camera, and
    every pose within 0.5 mm and 1e-3 rad of the JAX session's (the
    tolerance of `tests/test_torch_step.py`'s 10-frame parity), except the
    two frames of divergence D5, held to their own bounds."""
    a, b = two_logs
    eng = Engine(_camera(), EngineConfig(**CFG), device="cpu")
    processed = run_session(eng, make_camera_manager([a, b], W, H), max_frames=6)
    assert processed == {"cam0": 6, "cam1": 6}
    assert set(eng.frontends) == {"cam0", "cam1"}
    assert eng.frontends["cam0"].tick == 6
    assert eng.surfel_count("cam0") > 0 and eng.surfel_count("cam1") > 0
    assert len(eng.frontends["cam0"].trajectory) == 6

    jeng = JEngine(JCamera(JRes(W, H), JIntr(*INTR), "cam"), JCfg(**CFG))
    jprocessed = jcm.run_session(jeng, jcm.make_camera_manager([a, b], W, H), max_frames=6)
    assert jprocessed == processed
    for cam in processed:
        ours, theirs = eng.frontends[cam].trajectory, jeng.frontends[cam].trajectory
        assert [t for t, _ in ours] == [t for t, _ in theirs]
        for i, ((_, p), (_, q)) in enumerate(zip(ours, theirs)):
            dT = np.linalg.inv(q) @ p
            gap = np.linalg.norm(dT[:3, 3])
            if (cam, i) in D5_FRAMES:
                assert gap < D5_FRAMES[cam, i], (cam, i, gap)
                continue
            assert gap < 5e-4, (cam, i, gap)
            assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-3


def test_mixed_session_log_plus_live(two_logs):
    a, _ = two_logs
    recv = FrameReceiver(port=0)
    mgr = make_camera_manager([a], W, H, n_sensors=2, live_port=recv.port)
    # replace the factory's receiver with ours (port 0 would race otherwise)
    mgr.live.receiver.close()
    mgr.live = StreamCameraManager(recv, depth_factor=1000.0)
    seq = SyntheticSequence(camera=_camera(), num_frames=16)
    sender = FrameSender("live0", port=recv.port)
    try:
        for i in range(4, 8):
            rgb, depth = seq.frame(i)
            sender.send(np.asarray(rgb), (np.asarray(depth) * 1000).astype(np.uint16),
                        timestamp=i, last=(i == 7))
        assert mgr.wait_for_cameras(2, timeout=10.0)
        assert set(mgr.cameras()) == {"cam0", "live0"}
        eng = Engine(_camera(), EngineConfig(**CFG), device="cpu")
        processed = run_session(eng, mgr, max_frames=4, wait_timeout=0.3)
        assert processed["cam0"] == 4
        assert processed["live0"] == 4
        assert eng.frontends["live0"].tick == 4
    finally:
        sender.close()
        recv.close()
