"""Inter-map merges on the PyTorch port (CPU): the merge functions of
`loops` held against the JAX package's on the same numpy inputs, and two
cameras of one engine held to the bounds of `tests/test_intermap.py` and
`tests/test_engine.py::test_engine_multi_frontend_isolated_maps`, then
stepping into their one shared map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.mapping import ferns as jferns
from densemonoslam_tpu.tracking import odometry as jodo
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import deformation as tdg
from densemonoslam_tpu_torch.mapping import ferns as tferns
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.tracking import odometry as todo

torch.set_num_threads(2)

# tests/test_intermap.py::test_intermap_merge's configuration
CFG = dict(
    max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=False, loop_check_interval=4, time_delta=500, confidence_threshold=1.0,
)
# positions and normals move by one f32 rigid transform: a few ulps of 1 m
ATOL = 1e-5


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


def _offset():
    """camB's private world frame differs from camA's by this transform."""
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [1.0, 0.3, -0.5]
    return T


def _maps(rng, nb, na, capB=1 << 12, capA=1 << 10):
    data_b = np.zeros((capB + 1, 16), np.float32)
    data_b[:nb, 0:3] = rng.normal(0, 1, (nb, 3))
    data_b[:nb, sm.CONF] = 5.0
    data_b[:nb, sm.INIT_TIME] = np.arange(nb)
    data_a = np.zeros((capA + 1, 16), np.float32)
    data_a[:na, 0:3] = rng.normal(0, 1, (na, 3))
    data_a[:na, 8:11] = rng.normal(0, 1, (na, 3))
    data_a[:na, sm.CONF] = np.where(rng.random(na) < 0.2, 0.0, 3.0)  # dead rows inside
    data_a[:na, sm.INIT_TIME] = np.arange(na) + 50
    return data_b, data_a


@pytest.mark.parametrize("nb,na", [(100, 60), (4000, 900)], ids=["fits", "overflow"])
def test_merge_maps_matches_reference(nb, na):
    """The live rows of A land transformed after B's count; past capacity
    (one row of headroom kept) they are dropped and counted."""
    data_b, data_a = _maps(np.random.default_rng(0), nb, na)
    T = _offset()
    jd, jc, jdrop = jloops.merge_maps(
        jnp.asarray(data_b), jnp.asarray(nb, jnp.int32), jnp.asarray(data_a),
        jnp.asarray(na, jnp.int32), jnp.asarray(T),
    )
    td, tc, tdrop = tloops.merge_maps(
        torch.from_numpy(data_b.copy()), torch.tensor(nb), torch.from_numpy(data_a),
        torch.tensor(na), torch.from_numpy(T),
    )
    assert int(tc) == int(jc) and tdrop == int(jdrop)
    if nb == 4000:
        assert tdrop > 0 and int(tc) == (1 << 12) - 1
    np.testing.assert_allclose(td[:-1].numpy(), np.asarray(jd)[:-1], atol=ATOL)
    rows, n_alive = tloops._transform_rows(torch.from_numpy(data_a), torch.tensor(na), torch.from_numpy(T))
    jrows, jn = jloops._transform_rows(jnp.asarray(data_a), jnp.asarray(na, jnp.int32), jnp.asarray(T))
    assert int(n_alive) == int(jn)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), atol=ATOL)


def _rigid(rng):
    """A rigid transform of any rotation (axis-angle, angle up to pi) and a
    translation of about a metre."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(0.5, np.pi)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    T[:3, 3] = rng.normal(0, 1, 3)
    return T.astype(np.float32)


@pytest.mark.parametrize("nb,na", [(100, 60), (4000, 900)], ids=["fits", "overflow"])
def test_merge_maps_matches_reference_under_any_rotation(nb, na):
    """As above with a random rigid transform of up to pi radians, where a
    transform applied the wrong way round or transposed lands far off; the
    moved normals keep unit length."""
    rng = np.random.default_rng(nb + na)
    data_b, data_a = _maps(rng, nb, na)
    nrm = data_a[:na, 8:11]
    data_a[:na, 8:11] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    T = _rigid(rng)
    jd, jc, jdrop = jloops.merge_maps(
        jnp.asarray(data_b), jnp.asarray(nb, jnp.int32), jnp.asarray(data_a),
        jnp.asarray(na, jnp.int32), jnp.asarray(T),
    )
    td, tc, tdrop = tloops.merge_maps(
        torch.from_numpy(data_b.copy()), torch.tensor(nb), torch.from_numpy(data_a),
        torch.tensor(na), torch.from_numpy(T),
    )
    assert int(tc) == int(jc) and tdrop == int(jdrop)
    np.testing.assert_allclose(td[:-1].numpy(), np.asarray(jd)[:-1], atol=ATOL)
    moved = td[nb:int(tc)].numpy()
    live = data_a[:na][data_a[:na, sm.CONF] > 0][: moved.shape[0]]
    np.testing.assert_allclose(moved[:, 0:3], live[:, 0:3] @ T[:3, :3].T + T[:3, 3], atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(moved[:, 8:11], axis=1), 1.0, atol=ATOL)
    wrong = live[:, 0:3] @ T[:3, :3] + T[:3, 3]
    assert np.abs(moved[:, 0:3] - wrong).max() > 0.1


def test_merge_rel_banks_matches_reference():
    rng = np.random.default_rng(1)

    def bank(n_valid, nxt):
        src = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        return dict(src=src, dst=src + 0.01, src_time=rng.uniform(0, 50, 64).astype(np.float32),
                    dst_time=rng.uniform(0, 50, 64).astype(np.float32),
                    valid=np.arange(64) < n_valid, next=np.int32(nxt))

    dst, src = bank(40, 40), bank(30, 30)  # the ring wraps
    T = _offset()

    def jbank(b):
        return jloops.RelBank(
            cons=jloops.dg.RelConstraint(**{k: jnp.asarray(b[k]) for k in jloops.dg.RelConstraint._fields}),
            next=jnp.asarray(b["next"], jnp.int32),
        )

    j = jloops.merge_rel_banks(jbank(dst), jbank(src), jnp.asarray(T))
    t = tloops.merge_rel_banks(
        tloops.rel_bank_from_numpy(dst, "cpu"), tloops.rel_bank_from_numpy(src, "cpu"), torch.from_numpy(T)
    )
    assert int(t.next) == int(j.next)
    for k in tdg.RelConstraint._fields:
        np.testing.assert_allclose(
            getattr(t.cons, k).numpy(), np.asarray(getattr(j.cons, k)), atol=ATOL, err_msg=k
        )


@pytest.mark.parametrize("cb,ca", [(3, 4), (14, 6)], ids=["fits", "overflow"])
def test_consume_ferns_matches_reference(cb, ca):
    rng = np.random.default_rng(2)

    def db(count, K=16):
        return dict(
            codes=rng.integers(0, 16, (K, 50)).astype(np.int32),
            poses=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)) + rng.normal(0, 0.1, (K, 4, 4)).astype(np.float32),
            intensity=rng.uniform(0, 255, (K, 6, 8)).astype(np.float32),
            depth=rng.uniform(0, 4, (K, 6, 8)).astype(np.float32),
            times=rng.uniform(0, 50, K).astype(np.float32), count=np.int32(count),
        )

    b, a = db(cb), db(ca)
    T = _offset()
    j = jloops.consume_ferns(
        jferns.FernDB(**{k: jnp.asarray(v) for k, v in b.items()}),
        jferns.FernDB(**{k: jnp.asarray(v) for k, v in a.items()}), jnp.asarray(T),
    )

    def tdb(d):
        return tferns.FernDB(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})._replace(
            count=torch.tensor(int(d["count"]))
        )

    t = tloops.consume_ferns(tdb(b), tdb(a), torch.from_numpy(T))
    assert int(t.count) == int(j.count) == min(cb + ca, 16)
    for k in ("codes", "intensity", "depth", "times"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), atol=ATOL)


@pytest.fixture(scope="module")
def camb_map(seq):
    """camB's map and fern DB after 8 ground-truth frames in its own frame."""
    eng = Engine(seq.camera, EngineConfig(**CFG), device="cpu")
    fe = eng.frontend("camB")
    off = _offset()
    for i in range(6, 14):
        eng.process_frame("camB", *seq.frame(i), float(i), in_pose=(off @ seq.gt_pose(i)).astype(np.float32))
    assert int(fe.fern_state.db.count) >= 1
    return eng, fe


@pytest.mark.parametrize("query", [7, 30], ids=["overlap", "elsewhere"])
def test_resolve_intermap_matches_reference(seq, camb_map, query):
    """camA's view of frame `query` resolved in camB's map: the same fern
    match and decision, and the same pose in camB's frame within 1 mm."""
    eng, fe = camb_map
    cfg = EngineConfig(**CFG)
    be = eng.maps["camB"]
    rgb, depth = seq.frame(query)
    ff = tloops.fern_factor(cfg)
    db = fe.fern_state.db
    t_code = tferns.encode(
        fe.fern_state.coder, tferns.downsample_for_ferns(torch.from_numpy(rgb).float(), ff),
        tferns.downsample_for_ferns(torch.from_numpy(depth), ff),
    )
    t_pyr = todo.build_frame_pyramid(torch.from_numpy(rgb), torch.from_numpy(depth), seq.camera.intrinsics,
                                     cfg.pyramid_levels)
    t_pose, t_ok, t_info = tloops.resolve_intermap(
        t_pyr, t_code, db, be.map_data, be.map_count, seq.camera, cfg
    )
    jcoder = jferns.make_coder(seq.camera.resolution.width // ff, seq.camera.resolution.height // ff,
                               cfg.depth_cutoff, num_ferns=cfg.num_ferns)
    j_code = jferns.encode(jcoder, jferns.downsample_for_ferns(jnp.asarray(rgb, jnp.float32), ff),
                           jferns.downsample_for_ferns(jnp.asarray(depth), ff))
    np.testing.assert_array_equal(np.asarray(j_code), t_code.numpy())
    jdb = jferns.FernDB(**{k: jnp.asarray(getattr(db, k).numpy()) for k in jferns.FernDB._fields})
    j_pose, j_ok, j_info = jloops.resolve_intermap(
        jodo.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(depth), seq.camera.intrinsics,
                                 cfg.pyramid_levels),
        j_code, jdb, jnp.asarray(be.map_data.numpy()), jnp.asarray(int(be.map_count), jnp.int32),
        seq.camera, JCfg(**CFG),
    )
    assert t_ok == j_ok and t_info["dissim"] == j_info["dissim"]
    assert t_ok == (query == 7)
    if t_ok:
        np.testing.assert_allclose(t_pose, np.asarray(j_pose), atol=1e-3)


@pytest.fixture(scope="module")
def merged(seq):
    """`tests/test_intermap.py::test_intermap_merge`'s two cameras, run until
    their maps merge."""
    eng = Engine(seq.camera, EngineConfig(**CFG), device="cpu")
    eng.frontend("camA")
    eng.frontend("camB")
    off = _offset()
    eng.frontends["camA"].pose = seq.gt_pose(0).astype(np.float32)
    eng.frontends["camB"].pose = (off @ seq.gt_pose(6)).astype(np.float32)
    merged_at = None
    for k in range(14):
        ia, ib = k, 6 + k
        eng.process_frame("camA", *seq.frame(ia), float(ia), in_pose=seq.gt_pose(ia).astype(np.float32))
        if len(eng.maps) == 1:
            merged_at = ("A", k)
            break
        eng.process_frame("camB", *seq.frame(ib), float(ib),
                          in_pose=(off @ seq.gt_pose(ib)).astype(np.float32))
        if len(eng.maps) == 1:
            merged_at = ("B", k)
            break
    return eng, merged_at


def test_engine_intermap_merge(seq, merged):
    """The JAX test's bounds: the cameras' relative pose within 0.05 m and
    0.05 rad of the truth, the merged map within 0.02 m (median) of the
    analytic scene."""
    eng, merged_at = merged
    assert merged_at is not None, "maps never merged"
    feA, feB = eng.frontends["camA"], eng.frontends["camB"]
    assert len(eng.maps) == 1 and feA.map_name == feB.map_name
    be = eng.maps[feA.map_name]
    assert sorted(be.contexts) == ["camA", "camB"] and be.dropped == 0
    poseA, poseB = feA.pose, feB.pose
    last_a = merged_at[1]
    last_b = 6 + merged_at[1] - (1 if merged_at[0] == "A" else 0)
    d = np.linalg.inv(np.linalg.inv(poseA) @ poseB) @ (
        np.linalg.inv(seq.gt_pose(last_a)) @ seq.gt_pose(last_b)
    )
    assert np.linalg.norm(d[:3, 3]) < 0.05
    assert np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)) < 0.05
    p = sm.snapshot(eng.map_of(feA.map_name)).positions
    if np.linalg.norm(poseA[:3, 3] - seq.gt_pose(last_a)[:3, 3]) >= 0.1:
        inv = np.linalg.inv(_offset())
        p = (inv[:3, :3] @ p.T).T + inv[:3, 3]
    lo, hi = seq.scene.lo, seq.scene.hi
    on_wall = np.min(np.minimum(np.abs(p - lo), np.abs(p - hi)), axis=1)
    on_sphere = np.min(np.abs(
        np.linalg.norm(p[:, None, :] - seq.scene.sphere_c[None], axis=-1) - seq.scene.sphere_r[None]
    ), axis=1)
    assert np.median(np.minimum(on_wall, on_sphere)) < 0.02


def test_engine_shared_map_after_compaction(seq, merged):
    """Both cameras step into the one merged map; camB steps right after
    camA's frame compacted it, and sees the compacted tensors."""
    eng, merged_at = merged
    feA, feB = eng.frontends["camA"], eng.frontends["camB"]
    be = eng.maps[feA.map_name]
    eng._compact_interval = feA.tick + 1  # camA's next frame compacts
    ia, ib = merged_at[1] + 1, merged_at[1] + 7
    before = eng.surfel_count(be.name)
    eng.process_frame("camA", *seq.frame(ia), float(ia))
    assert feA.tick % eng._compact_interval == 0
    assert feB.state.map_data is be.map_data and feB.state.map_count is be.map_count
    compacted = eng.surfel_count(be.name)
    alive = sm.SurfelMap(data=be.map_data, count=be.map_count).alive
    assert int(alive.sum()) == compacted  # no holes below the count
    info = eng.process_frame("camB", *seq.frame(ib), float(ib))
    assert info["tracking_ok"] == 1.0
    assert feA.state.map_data is be.map_data is feB.state.map_data
    assert be.map_count is feB.state.map_count
    after = eng.surfel_count(be.name)
    assert before - 5000 < compacted <= after < compacted + 20000
    assert np.isfinite(feA.pose).all() and np.isfinite(feB.pose).all()


def test_engine_multi_frontend_isolated_maps(seq):
    """Two frontends own independent maps until a merge."""
    eng = Engine(seq.camera, EngineConfig(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0),
                 device="cpu")
    eng.frontend("camA")
    eng.frontend("camB")
    assert eng.frontends["camB"].sensor_id == 1
    eng.process_frame("camA", *seq.frame(0), 0.0)
    eng.process_frame("camB", *seq.frame(5), 0.0)
    assert eng.surfel_count("camA") > 0 and eng.surfel_count("camB") > 0
    assert eng.frontends["camA"].map_name != eng.frontends["camB"].map_name
    assert eng.maps["camA"].map_data is not eng.maps["camB"].map_data


def test_three_cameras_merged_map_fern_database(seq, monkeypatch):
    """ROADMAP D4 / reference defect R7.  Cameras A, B and C are created in
    that order, then A's map merges into B's.  The fern, pyramid, merge and
    resolve calls are stubbed (each fern database is a name), so only the
    engines' choice of database shows:

    - the JAX engine queries map B through A's database (the earliest-created
      member), which lacks B's keyframes, and consumes C's ferns into A's;
    - the port queries map B through B's database, which received A's ferns
      in the merge, and consumes C's ferns into it as well (the first member
      of `MapBackend.contexts`, the map's own camera)."""
    import densemonoslam_tpu.engine as jengmod
    import densemonoslam_tpu_torch.engine as tengmod
    from densemonoslam_tpu.engine import Engine as JEngine

    queried = {}

    def resolve(tag):
        def fn(frame_pyr, code, db, *rest):
            queried[tag] = db
            return np.eye(4, dtype=np.float32), False, {}
        return fn

    for tag, loops, ferns, odo, surfels in (
        ("jax", jloops, jferns, jodo, jengmod.sm),
        ("port", tloops, tferns, todo, tengmod.sm),
    ):
        monkeypatch.setattr(loops, "resolve_intermap", resolve(tag))
        monkeypatch.setattr(loops, "merge_maps", lambda dd, dc, sd, sc, T: (dd, dc, 0))
        monkeypatch.setattr(loops, "consume_ferns", lambda dst, src, T: f"{dst}+{src}")
        monkeypatch.setattr(ferns, "encode", lambda coder, rgb8, d8: None)
        monkeypatch.setattr(ferns, "downsample_for_ferns", lambda x, f: x)
        monkeypatch.setattr(odo, "build_frame_pyramid", lambda *a: None)
        monkeypatch.setattr(surfels, "compact", lambda m, **kw: m)

    cfg = dict(CFG, max_surfels=1 << 10)
    rgb, depth = seq.frame(0)
    jeng = JEngine(seq.camera, JCfg(**cfg))
    teng = Engine(seq.camera, EngineConfig(**cfg), device="cpu")
    for eng, loops in ((jeng, jloops), (teng, tloops)):
        for cam in "ABC":
            eng.frontend(cam).fern_state = loops.FernLoopState(coder=f"coder{cam}", db=f"db{cam}")
        eng.merge_into("A", "B", np.eye(4, dtype=np.float32))
        assert eng.frontends["B"].fern_state.db == "dbB+dbA"  # both: B receives A's ferns
    jeng._try_intermap("C", rgb, depth)
    teng._try_intermap(teng.frontends["C"], torch.from_numpy(rgb), torch.from_numpy(depth))
    assert queried == {"jax": "dbA", "port": "dbB+dbA"}

    for eng in (jeng, teng):
        eng.merge_into("C", "B", np.eye(4, dtype=np.float32))
    jdbs = {c: f.fern_state.db for c, f in jeng.frontends.items()}
    tdbs = {c: f.fern_state.db for c, f in teng.frontends.items()}
    assert jdbs == {"A": "dbA+dbC", "B": "dbB+dbA", "C": "dbC"}  # reference R7
    assert tdbs == {"A": "dbA", "B": "dbB+dbA+dbC", "C": "dbC"}  # the port's choice
