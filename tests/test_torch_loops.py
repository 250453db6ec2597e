"""Parity of the port's local loop closure (`loops.try_local_loop`) with the
JAX package's, from one shared state: the two-epoch revisit of
`tests/test_loops.py::test_local_loop_corrects_drift` (ground-truth poses,
then the same views again 100 ticks later with an 8 cm drift), built by
the port's engine on the CPU and handed to both packages as numpy arrays.
The config is that test's with 2 pyramid levels instead of 3, which
shortens the compile of the JAX package's loop program (its tracking
unrolls per level)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu import step as jstep
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import EngineConfig as TCfg
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm

torch.set_num_threads(2)

CFG = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=50, deform_graph_sample_rate=600, max_deform_nodes=128,
    loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02, confidence_threshold=1.0,
    pyramid_levels=2,
)
DRIFT = np.array([0.08, 0.0, 0.0], np.float32)
N_EPOCH = 8


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def shared(seq):
    """The state after the drifted revisit, and a carried bank of relative
    constraints from an earlier closure, as numpy arrays."""
    eng = Engine(seq.camera, TCfg(**CFG), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(N_EPOCH):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    eng.global_tick = 100  # the first epoch becomes inactive
    for i in range(N_EPOCH):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
    rng = np.random.default_rng(3)
    src = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    bank = dict(src=src, dst=src + 0.002, src_time=np.full(64, 104.0, np.float32),
                dst_time=np.full(64, 4.0, np.float32), valid=np.arange(64) < 3, next=np.int32(3))
    return tstep.state_to_numpy(fe.state), bank


def _run_both(seq, state, bank):
    jbank = jloops.RelBank(
        cons=jloops.dg.RelConstraint(**{k: jnp.asarray(bank[k]) for k in
                                        jloops.dg.RelConstraint._fields}),
        next=jnp.asarray(bank["next"], jnp.int32),
    )
    js, jinfo, jg, jbank = jloops.try_local_loop(
        jstep.SlamState(**{k: jnp.asarray(v) for k, v in state.items()}), seq.camera, JCfg(**CFG),
        rel_bank=jbank,
    )
    jax.block_until_ready(js.map_data)
    ts, tinfo, tg, tbank = tloops.try_local_loop(
        tstep.state_from_numpy(state, "cpu"), seq.camera, TCfg(**CFG),
        rel_bank=tloops.rel_bank_from_numpy(bank, "cpu"),
    )
    return (js, jinfo, jg, jbank), (ts, tinfo, tg, tbank)


def test_local_loop_matches_reference(seq, shared):
    """Both close.  LoopInfo: coverage exact (the same render), inlier
    fraction within 1e-3, ICP and constraint errors within rtol 0.1 (both
    are ~1e-5..1e-6, where the trackers' f32 sums differ in the last
    digits).  The deformed map rows within 1 mm and 1e-3 on normals (the
    graphs are optimised from constraints that differ by the trackers' ~1e-5
    pose difference), the pose within 0.1 mm; reactivation picks the same
    rows but for at most 0.01%; every other column is untouched; the
    carried bank gets the same new pairs."""
    state, bank = shared
    (js, jinfo, jg, jbank), (ts, tinfo, tg, tbank) = _run_both(seq, state, bank)
    assert jinfo.closed and tinfo.closed, (jinfo, tinfo)
    assert tinfo.attempted
    assert tinfo.inactive_frac == pytest.approx(jinfo.inactive_frac, abs=1e-6)
    assert tinfo.inlier_frac == pytest.approx(jinfo.inlier_frac, abs=1e-3)
    assert tinfo.icp_error == pytest.approx(jinfo.icp_error, rel=0.1)
    assert tinfo.cons_error == pytest.approx(jinfo.cons_error, rel=0.1)

    n = int(state["map_count"])
    jd, td, d0 = np.asarray(js.map_data), ts.map_data.numpy(), state["map_data"]
    recent = d0[:n, sm.INIT_TIME] >= 100
    moved = td[:n, sm.POS] - d0[:n, sm.POS]
    assert np.abs(moved[recent]).mean() > 0.02  # the drifted epoch really moved
    np.testing.assert_allclose(td[:n, sm.POS], jd[:n, sm.POS], atol=1e-3)
    np.testing.assert_allclose(td[:n, sm.NORMAL], jd[:n, sm.NORMAL], atol=1e-3)
    assert np.mean(td[:n, 12] == jd[:n, 12]) > 0.9999
    untouched = [c for c in range(sm.COLS) if c not in (0, 1, 2, 8, 9, 10, 12)]
    np.testing.assert_array_equal(td[:, untouched], d0[:, untouched])
    np.testing.assert_array_equal(td[n:], d0[n:])
    np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose), atol=1e-4)
    assert int(ts.model_age) == int(js.model_age) == tstep.MODEL_INVALID_AGE
    np.testing.assert_allclose(tg.A.numpy(), np.asarray(jg.A), atol=1e-3)
    assert int(tbank.next) == int(jbank.next) > int(bank["next"])
    np.testing.assert_array_equal(tbank.cons.valid.numpy(), np.asarray(jbank.cons.valid))
    np.testing.assert_allclose(tbank.cons.src.numpy(), np.asarray(jbank.cons.src), atol=1e-3)
    np.testing.assert_array_equal(tbank.cons.src_time.numpy(), np.asarray(jbank.cons.src_time))
    np.testing.assert_array_equal(tbank.cons.dst_time.numpy(), np.asarray(jbank.cons.dst_time))


def test_local_loop_bails_out_without_inactive_model(seq, shared):
    """With the clock moved back so both epochs are active there is no
    inactive model: both stop at the first gate with the same coverage and
    leave state, map and bank as they were."""
    state, bank = shared
    state = {**state, "tick": np.int32(20)}
    (js, jinfo, jg, jbank), (ts, tinfo, tg, tbank) = _run_both(seq, state, bank)
    assert not jinfo.closed and not tinfo.closed
    assert tinfo.inactive_frac == pytest.approx(jinfo.inactive_frac, abs=1e-6)
    assert tinfo.inactive_frac < CFG["loop_min_inactive_frac"]
    assert (tinfo.inlier_frac, tinfo.icp_error, tinfo.cons_error) == (0.0, 0.0, 0.0)
    np.testing.assert_array_equal(ts.map_data.numpy(), state["map_data"])
    np.testing.assert_array_equal(ts.pose.numpy(), state["pose"])
    assert not bool(tg.valid.any())
    assert int(tbank.next) == int(bank["next"])
