"""The port's hybrid loop closure and the monocular hybrid slice against the
JAX package on the synthetic orbit at 160x120: `loops.apply_hybrid_loop` on
`tests/test_hybrid.py`'s two-epoch drifted map, the engine in `orb_tracking`
mode, and the engine with `predict_depth + orb_tracking + hybrid_loops` and
the packaged synthetic depth net."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu import step as jstep
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.engine import Engine as JEngine
from densemonoslam_tpu.models.depthnet import DepthPredictor as JDepth
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import EngineConfig as TCfg
from densemonoslam_tpu_torch.engine import Engine as TEngine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.models.depthnet import DepthPredictor as TDepth

torch.set_num_threads(2)

# tests/test_hybrid.py::test_apply_hybrid_loop_folds_map's configuration
HYBRID = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=50, deform_graph_sample_rate=600, max_deform_nodes=128,
    loop_cons_err_thresh=0.02, confidence_threshold=1.0,
)
DRIFT = np.array([0.08, 0.0, 0.0], np.float32)
# tests/test_hybrid.py::test_engine_orb_tracking_mode's configuration
ORB = dict(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
           open_loop=True, orb_tracking=True)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def drifted(seq):
    """The state after a ground-truth epoch and the same views 100 ticks
    later with an 8 cm drift, built by the port's engine, as numpy."""
    eng = TEngine(seq.camera, TCfg(**HYBRID), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(10):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    eng.global_tick = 100  # epoch 1 becomes inactive
    for i in range(10):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
    return tstep.state_to_numpy(fe.state)


def test_apply_hybrid_loop_matches_reference(seq, drifted):
    """Both accept; the constraint error (tens of micrometres after the
    fold) agrees within 2e-6 m, every surfel position and normal within
    1e-3 (as the local-loop parity test), the pose is C @ pose within 1e-5;
    and the port meets `test_hybrid.py`'s bounds (mean correction within
    0.35 |drift| of -drift, old surfels moved < 0.03 m)."""
    C = np.eye(4, dtype=np.float32)
    C[:3, 3] = -DRIFT
    js, jinfo, _ = jloops.apply_hybrid_loop(
        jstep.SlamState(**{k: jnp.asarray(v) for k, v in drifted.items()}), C, seq.camera,
        JCfg(**HYBRID),
    )
    jax.block_until_ready(js.map_data)
    ts, tinfo, tgraph = tloops.apply_hybrid_loop(
        tstep.state_from_numpy(drifted, "cpu"), C, seq.camera, TCfg(**HYBRID)
    )
    assert jinfo.closed and tinfo.closed
    np.testing.assert_allclose(tinfo.cons_error, jinfo.cons_error, atol=2e-6)
    n = int(drifted["map_count"])
    pre, post = drifted["map_data"][:n], ts.map_data.numpy()[:n]
    jd = np.asarray(js.map_data)[:n]
    np.testing.assert_allclose(post[:, sm.POS], jd[:, sm.POS], atol=1e-3)
    np.testing.assert_allclose(post[:, sm.NORMAL], jd[:, sm.NORMAL], atol=1e-3)
    np.testing.assert_allclose(ts.pose.numpy(), C @ drifted["pose"], atol=1e-5)
    assert int(ts.model_age) == tstep.MODEL_INVALID_AGE
    assert bool(tgraph.valid.any())
    moved = post[:, sm.POS] - pre[:, sm.POS]
    t0 = pre[:, sm.INIT_TIME]
    np.testing.assert_allclose(moved[t0 >= 100].mean(axis=0), -DRIFT,
                               atol=0.35 * np.linalg.norm(DRIFT))
    assert np.abs(moved[t0 < 50]).max() < 0.03


def _run_pair(seq, cfg: dict, n: int, mono: bool):
    """Both engines over the first `n` frames (RGB only when `mono`);
    returns their [n, 29] stats and the frontends."""
    je, te = JEngine(seq.camera, JCfg(**cfg)), TEngine(seq.camera, TCfg(**cfg), device="cpu")
    je.frontend("cam0")
    te.frontend("cam0")
    if mono:
        je.set_depth_predictor(JDepth.pretrained_synthetic())
        te.set_depth_predictor(TDepth.pretrained_synthetic(device="cpu"))
    for e in (je, te):
        e.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    for i in range(n):
        rgb, depth = seq.frame(i)
        je.process_frame("cam0", rgb, None if mono else depth, float(i), sync=False)
        te.process_frame("cam0", rgb, None if mono else depth, float(i), sync=False)
    jf, tf = je.frontends["cam0"], te.frontends["cam0"]
    jst = np.stack([np.asarray(s) for s in jf.stats_log])
    tst = torch.stack(tf.stats_log).numpy()
    return jst, tst, jf, tf


def _hold(jst, tst, jf, tf):
    """Per-frame stats: the same tracking and fuse decisions and surfel
    counts within 0.5%; poses within 2e-3 m and 2e-3 in the rotation
    entries (the sparse tracker's octaves >= 1 see resizes that differ by
    float rounding); the same sparse keyframe ticks."""
    for col in (tstep.STAT_TRACK_OK, tstep.STAT_FUSED):
        np.testing.assert_array_equal(tst[:, col], jst[:, col])
    np.testing.assert_allclose(tst[:, tstep.STAT_SURFELS], jst[:, tstep.STAT_SURFELS], rtol=5e-3)
    P = tstep.STAT_POSE0
    pj, pt = jst[:, P:].reshape(-1, 4, 4), tst[:, P:].reshape(-1, 4, 4)
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=2e-3)
    jt, tt = jf.sparse_tracker, tf.sparse_tracker
    jt.flush()
    tt.flush()
    assert [k[2] for k in tt.keyframes] == [k[2] for k in jt.keyframes]


def test_engine_orb_tracking_matches_reference(seq):
    """`orb_tracking=True` over 10 frames: the pose comes from the sparse
    tracker in both packages, and the port's trajectory meets
    `test_hybrid.py`'s bound (ATE < 5 cm)."""
    from densemonoslam_tpu_torch.eval import ate_rmse

    jst, tst, jf, tf = _run_pair(seq, ORB, 10, mono=False)
    _hold(jst, tst, jf, tf)
    assert (tst[:, tstep.STAT_TRACK_OK] == 1.0).all()
    est = [p for _, p in tf.trajectory]
    assert ate_rmse(est, [seq.gt_pose(i) for i in range(10)]) < 0.05


def test_engine_monocular_hybrid_slice_matches_reference(seq):
    """The slice as a whole: `predict_depth + orb_tracking + hybrid_loops`
    with the packaged synthetic depth net, RGB only, over 8 frames."""
    cfg = dict(ORB, predict_depth=True, hybrid_loops=True)
    jst, tst, jf, tf = _run_pair(seq, cfg, 8, mono=True)
    _hold(jst, tst, jf, tf)
    assert np.isfinite(tst).all()
    assert tst[-1, tstep.STAT_SURFELS] > 1000
