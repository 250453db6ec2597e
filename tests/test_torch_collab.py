"""The collaborative step and local-loop round of the PyTorch port
(`parallel.collab`) on two gloo ranks of the CPU, held against the JAX
package's `make_collab_step` / `make_collab_local_loop` on two of the
virtual CPU devices, on the same frames and states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu import step as jstep
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.parallel import collab as jcollab
from densemonoslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from torch_ranks import run_ranks

torch.set_num_threads(2)

# tests/test_intermap_collab.py's session
STEP_CFG = dict(
    max_surfels=1 << 16, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=200, max_depth=8.0,
)
N_FRAMES, OFFSET = 4, 6
# tests/test_torch_loops.py's two-epoch revisit (2 pyramid levels), in a
# 1<<16-row map (the second epoch fills it)
LOOP_CFG = dict(
    max_surfels=1 << 16, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=50, deform_graph_sample_rate=600, max_deform_nodes=128,
    loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02, confidence_threshold=1.0,
    pyramid_levels=2,
)
DRIFT = np.array([0.08, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.3, max_angle=0.25)


STEP_BODY = """
from densemonoslam_tpu_torch.config import EngineConfig, CameraIntrinsics
from densemonoslam_tpu_torch.parallel import collab, mesh as meshmod
mesh = meshmod.make_mesh(n_cams=n)
H, W = args["rgb"].shape[2:4]
step = collab.make_collab_step(mesh, CameraIntrinsics(*args["intr"]), H, W, EngineConfig(**args["cfg"]))
state = collab.init_state(args["cfg"]["max_surfels"], H, W, device="cpu")
stats, totals = [], []
for i in range(args["rgb"].shape[0]):
    state, s, total = step(state, torch.from_numpy(args["rgb"][i, rank]),
                           torch.from_numpy(args["depth"][i, rank]))
    stats.append(s.numpy())
    totals.append(int(total))
out["stats"], out["totals"] = np.stack(stats), totals
out["count"] = int(state.map_count)
"""


def test_collab_step_matches_reference(seq, tmp_path):
    """Four frames of two cameras 6 orbit frames apart from empty maps: both
    ranks see the same gathered stats and total, bit for bit; against the
    JAX package the same fuse decisions, poses within 0.5 mm and 1e-3 rad
    and surfel counts within 1% (the tolerances of
    `tests/test_torch_step.py`'s independent runs)."""
    rgb = np.stack([np.stack([seq.frame(i)[0], seq.frame(i + OFFSET)[0]]) for i in range(N_FRAMES)])
    dep = np.stack([np.stack([seq.frame(i)[1], seq.frame(i + OFFSET)[1]]) for i in range(N_FRAMES)])
    H, W = rgb.shape[2:4]
    intr = seq.camera.intrinsics
    res = run_ranks(2, STEP_BODY, dict(rgb=rgb, depth=dep, intr=(intr.fx, intr.fy, intr.cx, intr.cy),
                                       cfg=STEP_CFG), tmp_path)
    np.testing.assert_array_equal(res[0]["stats"], res[1]["stats"])
    assert res[0]["totals"] == res[1]["totals"]
    assert res[0]["totals"][-1] == res[0]["count"] + res[1]["count"]

    mesh = jmake_mesh(n_cams=2, n_map=1, devices=jax.devices()[:2])
    step = jcollab.make_collab_step(mesh, intr, H, W, JCfg(**STEP_CFG))
    state = jcollab.init_state(2, STEP_CFG["max_surfels"], H, W)
    jstats, jtotals = [], []
    for i in range(N_FRAMES):
        state, stats, total = step(state, jnp.asarray(rgb[i]), jnp.asarray(dep[i]))
        jstats.append(np.asarray(stats))
        jtotals.append(int(total))
    jst, tst = np.stack(jstats), res[0]["stats"]  # [frames, cams, 29]
    assert tst.shape == jst.shape == (N_FRAMES, 2, tstep.N_STATS_TOTAL)
    assert (tst[..., tstep.STAT_TRACK_OK] == 1).all()
    np.testing.assert_array_equal(tst[..., tstep.STAT_FUSED], jst[..., tstep.STAT_FUSED])
    for a, b in zip(tst[..., tstep.STAT_POSE0:].reshape(-1, 16), jst[..., tstep.STAT_POSE0:].reshape(-1, 16)):
        dT = np.linalg.inv(b.reshape(4, 4)) @ a.reshape(4, 4)
        assert np.linalg.norm(dT[:3, 3]) < 5e-4
        assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-3
    np.testing.assert_allclose(tst[..., tstep.STAT_SURFELS], jst[..., tstep.STAT_SURFELS], rtol=0.01)
    np.testing.assert_allclose(res[0]["totals"], jtotals, rtol=0.01)


LOOP_BODY = """
from densemonoslam_tpu_torch import loops, step as stepmod
from densemonoslam_tpu_torch.config import EngineConfig, CameraIntrinsics
from densemonoslam_tpu_torch.parallel import collab, mesh as meshmod
mesh = meshmod.make_mesh(n_cams=n)
st = args["states"][rank]
H, W = st["pred_depth"].shape
run = collab.make_collab_local_loop(mesh, CameraIntrinsics(*args["intr"]), H, W,
                                    EngineConfig(**args["cfg"]))
state, bank, infos = run(stepmod.state_from_numpy(st, "cpu"),
                         loops.rel_bank_from_numpy(args["bank"], "cpu"))
out["infos"] = infos.numpy()
out["state"] = stepmod.state_to_numpy(state)
out["bank_next"] = int(bank.next)
"""


@pytest.fixture(scope="module")
def loop_states(seq):
    """Camera 0: `tests/test_torch_loops.py`'s drifted revisit (its loop
    closes); camera 1: the same map with the clock moved back, so there is
    no inactive model (it stops at the first gate)."""
    eng = Engine(seq.camera, EngineConfig(**LOOP_CFG), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(8):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    eng.global_tick = 100
    for i in range(8):
        pose = seq.gt_pose(i).astype(np.float32)
        pose[:3, 3] += DRIFT
        eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
    closing = tstep.state_to_numpy(fe.state)
    bank = dict(src=np.zeros((64, 3), np.float32), dst=np.zeros((64, 3), np.float32),
                src_time=np.zeros(64, np.float32), dst_time=np.zeros(64, np.float32),
                valid=np.zeros(64, bool), next=np.int32(0))
    return [closing, {**closing, "tick": np.int32(20)}], bank


def test_collab_local_loop_matches_reference(seq, loop_states, tmp_path):
    """One local-loop round over two ranks: the gathered outcome vectors the
    same on both ranks bit for bit; against the JAX package camera 0 closes
    and camera 1 does not, with `tests/test_torch_loops.py`'s tolerances
    (coverage 1e-6, inlier fraction 1e-3, errors rtol 0.1, the deformed map
    within 1 mm, the pose within 0.1 mm)."""
    states, bank = loop_states
    intr = seq.camera.intrinsics
    res = run_ranks(2, LOOP_BODY, dict(states=states, bank=bank, cfg=LOOP_CFG,
                                       intr=(intr.fx, intr.fy, intr.cx, intr.cy)), tmp_path)
    np.testing.assert_array_equal(res[0]["infos"], res[1]["infos"])
    H, W = states[0]["pred_depth"].shape
    mesh = jmake_mesh(n_cams=2, n_map=1, devices=jax.devices()[:2])
    run = jcollab.make_collab_local_loop(mesh, intr, H, W, JCfg(**LOOP_CFG))
    jstate = jstep.SlamState(**{k: jnp.stack([jnp.asarray(s[k]) for s in states])
                                for k in jstep.SlamState._fields})
    jbank = jloops.RelBank(
        cons=jloops.dg.RelConstraint(**{k: jnp.stack([jnp.asarray(bank[k])] * 2)
                                        for k in jloops.dg.RelConstraint._fields}),
        next=jnp.zeros((2,), jnp.int32),
    )
    js, jb, jinfos = run(jstate, jbank)
    ti, ji = res[0]["infos"], np.asarray(jinfos)
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    assert list(ti[:, 0]) == [1.0, 0.0]
    np.testing.assert_allclose(ti[:, 1], ji[:, 1], atol=1e-6)
    np.testing.assert_allclose(ti[:, 2], ji[:, 2], atol=1e-3)
    np.testing.assert_allclose(ti[:, 3:], ji[:, 3:], rtol=0.1)
    n = int(states[0]["map_count"])
    td, jd = res[0]["state"]["map_data"], np.asarray(js.map_data)[0]
    np.testing.assert_allclose(td[:n, sm.POS], jd[:n, sm.POS], atol=1e-3)
    np.testing.assert_allclose(td[:n, sm.NORMAL], jd[:n, sm.NORMAL], atol=1e-3)
    np.testing.assert_allclose(res[0]["state"]["pose"], np.asarray(js.pose)[0], atol=1e-4)
    assert res[0]["bank_next"] == int(np.asarray(jb.next)[0]) > 0
    np.testing.assert_array_equal(res[1]["state"]["map_data"], states[1]["map_data"])
    assert res[1]["bank_next"] == int(np.asarray(jb.next)[1]) == 0
