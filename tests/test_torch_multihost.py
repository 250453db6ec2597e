"""A collaborative session of the PyTorch port over two gloo ranks of the
CPU, formed through `parallel.multihost.initialize()` from the environment,
one camera per rank (the scenario of `tests/test_multihost.py` and
`tests/test_intermap_collab.py`): 16 frames each in its own map, then
inter-map rounds until the maps merge.  Both ranks must report the same
merge, and the merge round (and its `consume=True` form) is held against
the JAX package's `make_intermap_round` on the same pre-round states and
frames.  `fern_insert`'s eviction is held against the JAX package's in one
process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import step as jstep
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.parallel import intermap as jim
from densemonoslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.parallel import intermap as tim
from torch_ranks import run_ranks

torch.set_num_threads(2)

CFG = dict(
    max_surfels=1 << 16, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True, time_delta=200, max_depth=8.0,
)
OFFSET, N_SOLO, N_MAX = 6, 16, 30
ROUND = dict(verify_scale=2, fern_factor=4)

SESSION_BODY = """
import copy
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.parallel import intermap
intr, cfg = CameraIntrinsics(*args["intr"]), EngineConfig(**args["cfg"])
rgb, dep = args["rgb"][rank], args["depth"][rank]
H, W = rgb.shape[1:3]
sess = multihost.MultiHostSession(intr, H, W, cfg, device="cpu")
assert sess.n_cams == n and list(sess.my_cam_slots) == [rank]
for i in range(args["n_solo"]):
    stats, total = sess.step(rgb[i][None], dep[i][None])
out["stats"], out["total"] = stats, total
sess.enable_intermap(**args["round"])
consume = intermap.make_intermap_round(sess.mesh, intr, H, W, cfg, consume=True, **args["round"])
for i in range(args["n_solo"], len(rgb)):
    sess.step(rgb[i][None], dep[i][None])
    pre = (copy.deepcopy(sess.state), copy.deepcopy(sess._im_state))
    info = sess.intermap_round(rgb[i][None], dep[i][None])
    if info.merged:
        break
out["frame"], out["info"] = i, info._asdict()
out["pre_state"], out["pre_ist"] = stepmod.state_to_numpy(pre[0]), as_numpy(pre[1])
out["state"], out["ist"] = stepmod.state_to_numpy(sess.state), as_numpy(sess._im_state)
state, ist, cinfo = consume(pre[0], pre[1], torch.from_numpy(rgb[i]), torch.from_numpy(dep[i]))
out["c_info"], out["c_state"], out["c_ist"] = as_numpy(cinfo), stepmod.state_to_numpy(state), as_numpy(ist)
"""


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.3, max_angle=0.25)


@pytest.fixture(scope="module")
def session(seq, tmp_path_factory):
    frames = [[seq.frame(i + c * OFFSET) for i in range(N_MAX)] for c in range(2)]
    rgb = np.stack([np.stack([f[0] for f in cam]) for cam in frames])
    dep = np.stack([np.stack([f[1] for f in cam]) for cam in frames])
    intr = seq.camera.intrinsics
    res = run_ranks(2, SESSION_BODY, dict(
        rgb=rgb, depth=dep, intr=(intr.fx, intr.fy, intr.cx, intr.cy), cfg=CFG,
        n_solo=N_SOLO, round=ROUND,
    ), tmp_path_factory.mktemp("session"))
    return rgb, dep, res


def test_session_stats_and_totals(session):
    """Every rank sees both cameras' stats rows and the same surfel total."""
    _, _, res = session
    for r in res:
        assert r["stats"].shape == (2, tstep.N_STATS_TOTAL)
        assert (r["stats"][:, tstep.STAT_SURFELS] > 0).all()
    np.testing.assert_array_equal(res[0]["stats"], res[1]["stats"])
    assert res[0]["total"] == res[1]["total"] == int(res[0]["stats"][:, tstep.STAT_SURFELS].sum())


def test_session_merge_agrees_and_matches_ground_truth(seq, session):
    """Both ranks report the same merge bit for bit; the applied transform
    is within `tests/test_intermap_collab.py`'s bounds of the truth (0.12 m,
    0.1 rad) and both cameras' poses in the merged frame within 0.2 m."""
    _, _, res = session
    i0, i1 = res[0]["info"], res[1]["info"]
    assert res[0]["frame"] == res[1]["frame"] < N_MAX - 1
    for k in i0:
        np.testing.assert_array_equal(i0[k], i1[k], err_msg=k)
    assert bool(i0["merged"]) and i0["map_ids"][0] == i0["map_ids"][1]
    req, tgt = int(i0["requester"]), int(i0["target"])
    starts = {0: seq.gt_pose(0), 1: seq.gt_pose(OFFSET)}
    T_true = np.linalg.inv(starts[tgt]) @ starts[req]
    T = i0["T"][req]
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.12
    assert np.arccos(np.clip((np.trace(T[:3, :3] @ T_true[:3, :3].T) - 1) / 2, -1, 1)) < 0.1
    last = res[0]["frame"]
    for c in (0, 1):
        expect = np.linalg.inv(starts[tgt]) @ seq.gt_pose(last + c * OFFSET)
        assert np.linalg.norm(res[c]["state"]["pose"][:3, 3] - expect[:3, 3]) < 0.2


def _jax_round(seq, session, consume):
    rgb, dep, res = session
    i = res[0]["frame"]
    H, W = rgb.shape[2:4]
    mesh = jmake_mesh(n_cams=2, n_map=1, devices=jax.devices()[:2])
    fn = jim.make_intermap_round(mesh, seq.camera.intrinsics, H, W, JCfg(**CFG), consume=consume, **ROUND)
    state = jstep.SlamState(**{k: jnp.stack([jnp.asarray(r["pre_state"][k]) for r in res])
                               for k in jstep.SlamState._fields})
    ist = jim.IntermapState(**{
        k: jnp.stack([jnp.asarray(r["pre_ist"][k]).astype(
            np.int32 if k in ("codes", "count", "map_id") else np.float32) for r in res])
        for k in jim.IntermapState._fields
    })
    js, jist, jinfo = fn(state, ist, jnp.asarray(rgb[:, i]), jnp.asarray(dep[:, i]))
    return js, jist, jinfo


def _same_merge(tinfo, jinfo):
    """Decisions exact; the transforms within 1 mm / 1e-3 (the verifying
    trackers' f32 sums differ in the last digits over up to 150
    iterations); proposals and fern dissimilarities exact; the requester's
    inlier fraction within 1e-2 and ICP error within rtol 0.2.  The other
    camera's verification aligns views that need not overlap, where the
    two trackers may settle apart: only its decision is held."""
    for k in ("merged", "src_map", "dst_map", "requester", "target", "map_ids", "dropped"):
        np.testing.assert_array_equal(np.asarray(tinfo[k]), np.asarray(getattr(jinfo, k)), err_msg=k)
    np.testing.assert_allclose(tinfo["T"], np.asarray(jinfo.T), atol=1e-3)
    js = np.asarray(jinfo.stats)
    np.testing.assert_array_equal(tinfo["stats"][:, [0, 3]], js[:, [0, 3]])
    req = int(tinfo["requester"])
    np.testing.assert_allclose(tinfo["stats"][req, 1], js[req, 1], atol=1e-2)
    np.testing.assert_allclose(tinfo["stats"][req, 2], js[req, 2], rtol=0.2)


def test_merge_round_matches_reference(seq, session):
    """The merge round from the same pre-round states and frames: the same
    MergeInfo (within `_same_merge`'s tolerances), poses within 1 mm, the
    source camera's map moved as the reference moves it (within 1e-3) and
    its fern keyframe poses with it."""
    _, _, res = session
    js, jist, jinfo = _jax_round(seq, session, consume=False)
    _same_merge(res[0]["info"], jinfo)
    req = int(res[0]["info"]["requester"])
    for c in (0, 1):
        np.testing.assert_allclose(res[c]["state"]["pose"], np.asarray(js.pose)[c], atol=1e-3)
        np.testing.assert_array_equal(res[c]["ist"]["map_id"], np.asarray(jist.map_id)[c])
        np.testing.assert_array_equal(res[c]["ist"]["count"], np.asarray(jist.count)[c])
    n = int(res[req]["state"]["map_count"])
    np.testing.assert_allclose(res[req]["state"]["map_data"][:n, sm.POS],
                               np.asarray(js.map_data)[req][:n, sm.POS], atol=1e-3)
    np.testing.assert_allclose(res[req]["ist"]["poses"], np.asarray(jist.poses)[req], atol=1e-3)
    assert int(res[req]["state"]["model_age"]) == tstep.MODEL_INVALID_AGE


def test_consume_round_matches_reference(seq, session):
    """`consume=True` on the same inputs: the same merge; the source camera's
    map and fern DB empty, the target's count grown by the source's live
    rows up to capacity and the rest counted as dropped (as in the
    reference)."""
    _, _, res = session
    js, jist, jinfo = _jax_round(seq, session, consume=True)
    _same_merge(res[0]["c_info"], jinfo)
    np.testing.assert_array_equal(res[0]["c_info"]["T"], res[1]["c_info"]["T"])
    req, tgt = int(res[0]["c_info"]["requester"]), int(res[0]["c_info"]["target"])
    counts = [int(r["c_state"]["map_count"]) for r in res]
    np.testing.assert_array_equal(counts, np.asarray(js.map_count))
    pre = res[req]["pre_state"]
    live = int((pre["map_data"][:-1, sm.CONF] > 0).sum())
    assert counts[req] == 0 and int(res[req]["c_ist"]["count"]) == 0
    # overflow is surfaced: what does not fit the target is counted
    cap, before = CFG["max_surfels"], int(res[tgt]["pre_state"]["map_count"])
    assert counts[tgt] == min(before + live, cap)
    assert int(res[0]["c_info"]["dropped"]) == max(live - (cap - before), 0)
    n = counts[tgt]
    np.testing.assert_allclose(res[tgt]["c_state"]["map_data"][:n, sm.POS],
                               np.asarray(js.map_data)[tgt][:n, sm.POS], atol=1e-3)


def test_fern_insert_evicts_like_reference():
    """`tests/test_intermap_collab.py::test_intermap_fern_db_evicts_when_full`
    on the port: K distinct places fill the DB, a late novel place evicts
    rather than freezes, and the evictee is one of a redundant twin pair;
    every step's DB equals the JAX package's."""
    rng = np.random.default_rng(3)
    K, F = tim.FERN_K, 64
    jone = jax.tree.map(lambda v: v[0], jim.init_state(1, num_ferns=F))
    tone = tim.init_state(0, num_ferns=F, device="cpu")
    jins = jax.jit(lambda i, c, p, t: jim.fern_insert(i, c, p, t, 0.3))
    eye = np.eye(4, dtype=np.float32)

    def both(j, t, code, tick):
        j = jins(j, jnp.asarray(code), jnp.asarray(eye), jnp.float32(tick))
        t = tim.fern_insert(t, torch.from_numpy(code), torch.from_numpy(eye),
                            torch.tensor(float(tick)), 0.3)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.times.numpy(), np.asarray(j.times))
        assert int(t.count) == int(j.count)
        return j, t

    codes = [rng.integers(0, 2, F).astype(np.int32) for _ in range(K)]
    for tick, c in enumerate(codes):
        jone, tone = both(jone, tone, c, tick)
    assert int(tone.count) == K
    late = rng.integers(0, 2, F).astype(np.int32)
    _, t2 = both(jone, tone, late, K + 1)
    assert int(t2.count) == K and (t2.codes.numpy() == late[None]).all(axis=1).any()
    twin_b = codes[5].copy()
    twin_b[0] = 1 - twin_b[0]
    jone = jone._replace(codes=jone.codes.at[7].set(jnp.asarray(twin_b)))
    tone = tone._replace(codes=tone.codes.clone())
    tone.codes[7] = torch.from_numpy(twin_b)
    newc = rng.integers(0, 2, F).astype(np.int32)
    _, t4 = both(jone, tone, newc, 99)
    s = t4.codes.numpy()
    assert not ((s == codes[5][None]).all(axis=1).any() and (s == twin_b[None]).all(axis=1).any())
    assert (s == newc[None]).all(axis=1).any()
