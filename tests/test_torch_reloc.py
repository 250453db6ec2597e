"""Fern relocalisation on the PyTorch port's engine (CPU), held to the
bounds of the JAX package's tests on the same fixture:
`tests/test_loops.py::test_relocalisation_recovers_pose` /
`test_relocalisation_rejects_wrong_fern_match` and
`tests/test_engine.py::test_engine_relocalisation_mode_recovers`, and
relocalisation's query and geometric verification held against the JAX
package's on the same map, fern database and frame.  All start from one
16-frame ground-truth run (relocalisation mode, loop checks every 4 frames),
each on its own copy of the engine or of its state."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.mapping import ferns as jferns
from densemonoslam_tpu.tracking import odometry as jodo
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import ferns as tferns
from densemonoslam_tpu_torch.tracking import odometry as todo

torch.set_num_threads(2)

CFG = dict(
    max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, open_loop=False,
    nid_keyframing=False, relocalisation=True, loop_check_interval=4, time_delta=200,
)
TELEPORT = np.eye(4, dtype=np.float32)
TELEPORT[:3, 3] = [5.0, 5.0, 5.0]


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def mapped(seq):
    eng = Engine(seq.camera, EngineConfig(**CFG), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(16):
        eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
    assert int(fe.fern_state.db.count) >= 1
    assert not fe.lost and fe.consecutive_bad == 0
    return eng


def test_relocalise_recovers_pose(seq, mapped):
    """From a wrong pose, a frame near a stored fern keyframe relocalises to
    within 0.3 m of ground truth (dense-tracking convergence range)."""
    eng = copy.deepcopy(mapped)
    fe = eng.frontends["cam0"]
    fe.pose = TELEPORT
    assert eng.relocalise("cam0", *seq.frame(5))
    assert np.linalg.norm(fe.pose[:3, 3] - seq.gt_pose(5)[:3, 3]) < 0.3
    assert int(fe.state.model_age) >= 1 << 20  # the stored model is invalidated


def test_relocalise_rejects_wrong_fern_match(seq, mapped):
    """A fern candidate with the right appearance but a wrong pose fails the
    geometric verification."""
    eng = copy.deepcopy(mapped)
    fe = eng.frontends["cam0"]
    wrong = seq.gt_pose(15).astype(np.float32)
    wrong[:3, 3] += np.array([0.8, 0.8, 0.0], np.float32)
    db = fe.fern_state.db
    fe.fern_state = fe.fern_state._replace(
        db=db._replace(poses=torch.from_numpy(wrong).expand_as(db.poses).clone())
    )
    before = fe.pose
    assert not eng.relocalise("cam0", *seq.frame(5))
    np.testing.assert_array_equal(fe.pose, before)


def test_engine_relocalisation_mode_recovers(seq, mapped):
    """Teleported far away with the stored model invalid, the device-side
    bad-frame counter trips at a poll and relocalisation brings the pose back
    within 1 m of the map."""
    eng = copy.deepcopy(mapped)
    fe = eng.frontends["cam0"]
    fe.pose = TELEPORT
    fe.state = fe.state.replace(model_age=torch.full_like(fe.state.model_age, 1 << 20))
    attempts = []
    relocalise = eng.relocalise

    def counting(*a, **k):
        attempts.append(relocalise(*a, **k))
        return attempts[-1]

    eng.relocalise = counting
    for i in range(30):
        eng.process_frame("cam0", *seq.frame(i % 16), float(100 + i))
    assert any(attempts), attempts
    err = np.linalg.norm(fe.pose[:3, 3] - seq.gt_pose(15)[:3, 3])
    assert err < 1.0, f"pose still far from the map: {err:.2f} m"


@pytest.fixture(scope="module")
def shared_reloc(mapped):
    """The mapped state and fern state as numpy arrays, for both packages."""
    fe = mapped.frontends["cam0"]
    fs = fe.fern_state
    ferns = {k: v.numpy() for k, v in {**fs.coder._asdict(), **fs.db._asdict()}.items()}
    return tstep.state_to_numpy(fe.state), ferns


@pytest.mark.parametrize(
    "offset, gates",
    [(0.0, {}), (0.0, dict(loop_inlier_frac=1.01)), (0.8, {})],
    ids=["accept", "reject-at-gate", "reject-wrong-pose"],
)
def test_relocalise_matches_reference(seq, shared_reloc, offset, gates):
    """Relocalisation's steps on the same map, fern database and query frame
    (frame 5) in both packages: the fern query picks the same keyframe with
    the same dissimilarity and photometric error (exact: bit-exact codes, the
    same integer counts; photometric error within 1e-4 relative, f32 sums in
    another order), then `verify_recovery` from that keyframe's pose, moved
    by `offset` metres in x and y, under the engine's gates changed by
    `gates`.  At the stored pose both accept, and both reject once the
    inlier gate is out of reach; 0.8 m off (the JAX package's wrong-match
    test) both reject.  Coverage is exact (the same render).  Where the
    tracking converges (at the stored pose): inlier fraction within 1e-3 and
    ICP error within rtol 0.1 (the trackers' f32 sums differ in the last
    digits, and an error this close to 0 carries few of them), the covariance
    maximum within rtol 0.05 (the inverse of the same 6x6 Hessian up to those
    sums), the refined pose within 1e-4 (the trackers' parity bound on the
    same inputs).  From 1.1 m off the tracking does not converge and the two
    f32 iterations part, so there both inlier fractions are only held below
    the inlier gate, as the reference's rejection needs."""
    state, ferns = shared_reloc
    tcfg, jcfg = EngineConfig(**CFG, **gates), JCfg(**CFG, **gates)
    rgb, depth = seq.frame(5)
    depth_m = depth.astype(np.float32) / CFG["depth_factor"]
    ff = tloops.fern_factor(tcfg)

    tfs = tloops.fern_state_from_numpy(ferns, "cpu")
    jcoder = jferns.FernCoder(**{k: jnp.asarray(ferns[k]) for k in jferns.FernCoder._fields})
    jdb = jferns.FernDB(**{k: jnp.asarray(ferns[k]) for k in jferns.FernDB._fields})
    t_rgb8 = tferns.downsample_for_ferns(torch.from_numpy(rgb).to(torch.float32), ff)
    t_d8 = tferns.downsample_for_ferns(torch.from_numpy(depth_m), ff)
    j_rgb8 = jferns.downsample_for_ferns(jnp.asarray(rgb, jnp.float32), ff)
    j_d8 = jferns.downsample_for_ferns(jnp.asarray(depth_m), ff)
    t_idx, t_dis = tferns.best_match(tfs.db, tferns.encode(tfs.coder, t_rgb8, t_d8))
    j_idx, j_dis = jferns.best_match(jdb, jferns.encode(jcoder, j_rgb8, j_d8))
    idx = int(j_idx)
    assert int(t_idx) == idx and float(t_dis) == float(j_dis) and float(j_dis) <= 0.9
    t_i8 = 0.299 * t_rgb8[..., 0] + 0.587 * t_rgb8[..., 1] + 0.114 * t_rgb8[..., 2]
    j_i8 = 0.299 * j_rgb8[..., 0] + 0.587 * j_rgb8[..., 1] + 0.114 * j_rgb8[..., 2]
    t_photo = tferns.photometric_check(tfs.db.intensity[idx], t_i8, tfs.db.depth[idx], t_d8)
    j_photo = jferns.photometric_check(jdb.intensity[idx], j_i8, jdb.depth[idx], j_d8)
    assert float(t_photo) == pytest.approx(float(j_photo), rel=1e-4)
    assert float(j_photo) <= tcfg.photo_thresh

    cand = ferns["poses"][idx].copy()
    cand[:3, 3] += np.array([offset, offset, 0.0], np.float32)
    j_pose, j_ok, j_info = jloops.verify_recovery(
        jodo.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(depth_m), seq.camera.intrinsics,
                                 jcfg.pyramid_levels),
        jnp.asarray(cand), jnp.asarray(state["map_data"]), jnp.asarray(state["map_count"]),
        seq.camera, jcfg,
    )
    ts = tstep.state_from_numpy(state, "cpu")
    t_pose, t_ok, t_info = tloops.verify_recovery(
        todo.build_frame_pyramid(torch.from_numpy(rgb), torch.from_numpy(depth_m),
                                 seq.camera.intrinsics, tcfg.pyramid_levels),
        torch.from_numpy(cand), ts.map_data, ts.map_count, seq.camera, tcfg,
    )
    assert j_ok == (offset == 0.0 and not gates), j_info
    assert t_ok == j_ok, (t_info, j_info)
    assert set(t_info) == set(j_info) == {"coverage", "inlier_frac", "icp_error", "icp_inliers", "cov_max"}
    assert t_info["coverage"] == pytest.approx(j_info["coverage"], abs=1e-6)
    if offset == 0.0:
        assert t_info["inlier_frac"] == pytest.approx(j_info["inlier_frac"], abs=1e-3)
        assert t_info["icp_error"] == pytest.approx(j_info["icp_error"], rel=0.1)
        assert t_info["cov_max"] == pytest.approx(j_info["cov_max"], rel=0.05)
    else:
        assert max(t_info["inlier_frac"], j_info["inlier_frac"]) < tcfg.loop_inlier_frac
    if j_ok:
        np.testing.assert_allclose(t_pose, j_pose, atol=1e-4)
        assert np.linalg.norm(t_pose[:3, 3] - seq.gt_pose(5)[:3, 3]) < 0.3
    else:
        assert t_pose is None and j_pose is None
