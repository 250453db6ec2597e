"""The distributed solves and the map-sharded pass of the PyTorch port over
gloo ranks of the CPU: edge-sharded PGO and landmark-sharded BA over a
mesh's `cam` group, held against the JAX package's `make_distributed_pgo` /
`make_distributed_ba` on two virtual CPU devices and against the port's
single-device solves; the sharded K2 apply over the `map` group held bit
for bit against one rank's; `SparseTracker(mesh=...)` against the
single-device tracker.  Four ranks form a 2 (cam) x 2 (map) mesh, which is
where the reference's BA sharding goes wrong (ROADMAP R2); three ranks run
PGO on a `cam` group whose size is not a power of two (R3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.mapping import deformation as jdg
from densemonoslam_tpu.parallel import ba as jba
from densemonoslam_tpu.parallel.map_shard import make_sharded_apply_to_map as jsharded
from densemonoslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from densemonoslam_tpu.utils import se3 as jse3
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import preprocess
from densemonoslam_tpu_torch.parallel import ba as tba
from densemonoslam_tpu_torch.tracking import sparse as tsparse
from torch_ranks import run_ranks

torch.set_num_threads(2)

INTR = (100.0, 100.0, 63.5, 47.5)
BA_OPTS = dict(iters=4, fix_cameras=2)
TRACKER = dict(keyframe_min_disp=0.03, local_ba_min_baseline=0.0, loop_min_gap=10, loop_min_votes=40)


def _exp(xi):
    return np.array(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


def _pose_graph(K=8, n_edges=8):
    """`tests/test_torch_ba.py`'s drifted ring of 8 keyframes with a loop
    edge, padded to 16 poses and `n_edges` edges."""
    rng = np.random.default_rng(3)
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        T = _exp(np.array([0.0, th, 0.0, 0.0, 0.0, 0.0]))
        T[:3, 3] = [3 * np.sin(th), 0.0, -3 * np.cos(th)]
        gt.append(T)
    edges, poses = [], [gt[0]]
    for k in range(1, K):
        Z = np.linalg.inv(gt[k - 1]) @ gt[k] @ _exp(rng.normal(0, [0.01] * 3 + [0.03] * 3))
        edges.append((k - 1, k, Z, 1.0))
        poses.append(poses[-1] @ Z)
    edges.append((0, K - 1, np.linalg.inv(gt[0]) @ gt[K - 1], 3.0))
    P = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    P[:K] = np.stack(poses)
    ei, ej = np.zeros(n_edges, np.int64), np.zeros(n_edges, np.int64)
    Z = np.tile(np.eye(4, dtype=np.float32), (n_edges, 1, 1))
    w = np.zeros(n_edges, np.float32)
    for e, (i, j, Ze, we) in enumerate(edges):
        ei[e], ej[e], Z[e], w[e] = i, j, Ze, we
    return P, ei, ej, Z, w


def _ba_problem():
    """6 cameras on a ring looking at 64 points, noisy initial poses (the
    first two at the truth) and points (`tests/test_ba.py`'s problem)."""
    rng = np.random.default_rng(0)
    fx, fy, cx, cy = INTR
    K, Pn = 6, 64
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = [0.4 * np.sin(a), 0.1 * np.sin(2 * a), 0.4 * (np.cos(a) - 1)]
        gt.append(T)
    pts = rng.uniform(-1.0, 1.0, (Pn, 3)).astype(np.float32) + np.float32([0, 0, 3])
    cam, pnt, uv = [], [], []
    for c in range(K):
        Tinv = np.linalg.inv(gt[c])
        for p in range(Pn):
            X = Tinv[:3, :3] @ pts[p] + Tinv[:3, 3]
            u, v = X[0] / X[2] * fx + cx, X[1] / X[2] * fy + cy
            if X[2] > 0.2 and 0 <= u < 128 and 0 <= v < 96:
                cam.append(c)
                pnt.append(p)
                uv.append([u, v])
    poses = np.stack([gt[c] @ (_exp(rng.normal(0, 0.02, 6)) if c > 1 else np.eye(4)) for c in range(K)])
    return dict(
        poses=poses.astype(np.float32), points=(pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32),
        cam_idx=np.array(cam, np.int64), pnt_idx=np.array(pnt, np.int64),
        uv=np.array(uv, np.float32), valid=np.ones(len(cam), bool), z=np.zeros(len(cam), np.float32),
    )


def _map_and_graph():
    """`tests/test_ba.py::test_sharded_apply_to_map_matches_single_device`'s
    map (4096 rows, 3000 live) and 32-node graph."""
    rng = np.random.default_rng(3)
    N, n, K = 4096, 3000, 32
    data = np.zeros((N + 1, sm.COLS), np.float32)
    data[:n, 0:3] = rng.uniform(-2, 2, (n, 3))
    data[:n, sm.CONF] = rng.uniform(0.5, 20.0, n)
    data[:n, 8:11] = rng.normal(0, 1, (n, 3))
    data[:n, sm.INIT_TIME] = np.sort(rng.uniform(0, 31, n))
    pos = np.zeros((K, 3), np.float32)
    pos[:, 0] = np.linspace(-2, 2, K)
    graph = dict(
        pos=pos, time=np.linspace(0, 31, K).astype(np.float32), valid=np.ones(K, bool),
        A=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        t=np.where(np.arange(K)[:, None] >= K // 2, [0.1, 0.05, 0.0], 0.0).astype(np.float32),
    )
    return data, n, graph


MESH_BODY = """
from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.ops import preprocess
from densemonoslam_tpu_torch.parallel import ba, map_shard, mesh as meshmod
from densemonoslam_tpu_torch.tracking.sparse import SparseTracker
mesh = meshmod.make_mesh(n_cams=args["n_cams"], n_map=args["n_map"])
assert (mesh.cam, mesh.map) == divmod(rank, args["n_map"])
T = torch.from_numpy
P, ei, ej, Z, w = args["pgo"]
poses, err = ba.make_distributed_pgo(mesh, cg_iters=128)(T(P), ba.PoseGraphEdges(T(ei), T(ej), T(Z), T(w)))
out["pgo"], out["pgo_err"] = poses.numpy(), float(err)
if "ba" in args:
    d = args["ba"]
    lay = ba.shard_ba_problem(ba.BAProblem(**d), mesh.n_cams)
    run = ba.make_distributed_ba(mesh, CameraIntrinsics(*args["intr"]), **args["ba_opts"])
    p, pts, err = run(T(d["poses"]), *map(T, lay))
    out["ba"], out["ba_err"] = p.numpy(), float(err)
    data, count, graph = args["map"]
    apply = map_shard.make_sharded_apply_to_map(mesh)
    out["map"] = apply(T(data.copy()), torch.tensor(count), dg.graph_from_numpy(graph, "cpu")).numpy()
    trk = SparseTracker(CameraIntrinsics(*args["seq_intr"]), device="cpu", mesh=mesh, **args["tracker"])
    trk.pose = args["pose0"]
    for inten, depth in args["frames"]:
        trk.track(T(inten), T(depth))
    trk.flush()
    out["trk"] = dict(kf=np.stack([p for _, p, _ in trk.keyframes]), pose=trk.pose,
                      ba_runs=trk.local_ba_runs, loops=trk.loops_closed)
"""


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def tracker_frames(seq):
    return [(preprocess.rgb_to_intensity(torch.from_numpy(rgb)).numpy(), depth)
            for rgb, depth in (seq.frame(i) for i in list(range(14)) + list(range(8)))]


@pytest.fixture(scope="module")
def mesh_run(seq, tracker_frames, tmp_path_factory):
    i = seq.camera.intrinsics
    args = dict(
        n_cams=2, n_map=2, pgo=_pose_graph(n_edges=16), ba=_ba_problem(), ba_opts=BA_OPTS,
        intr=INTR, map=_map_and_graph(), seq_intr=(i.fx, i.fy, i.cx, i.cy),
        tracker=TRACKER, pose0=seq.gt_pose(0).astype(np.float32), frames=tracker_frames,
    )
    return args, run_ranks(4, MESH_BODY, args, tmp_path_factory.mktemp("mesh"))


def test_distributed_pgo_matches_reference(mesh_run):
    """Edges split over each `cam` group of two: every rank holds the same
    poses; within 2e-4 of the JAX package's edge-sharded PGO on two devices
    and of the port's single-device PGO (the all-reduce sums partials in
    another order), the error within rtol 1e-3."""
    args, res = mesh_run
    for r in res[1:]:
        np.testing.assert_array_equal(r["pgo"], res[0]["pgo"])
    P, ei, ej, Z, w = args["pgo"]
    jrun = jba.make_distributed_pgo(jmake_mesh(n_cams=2, n_map=1, devices=jax.devices()[:2]),
                                    cg_iters=128)
    jout, jerr = jrun(jnp.asarray(P), jba.PoseGraphEdges(
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32), jnp.asarray(Z), jnp.asarray(w)))
    single, serr = tba.optimise_pose_graph(
        torch.from_numpy(P), tba.PoseGraphEdges(*map(torch.from_numpy, (ei, ej, Z, w))), cg_iters=128)
    np.testing.assert_allclose(res[0]["pgo"], np.asarray(jout), atol=2e-4)
    np.testing.assert_allclose(res[0]["pgo"], single.numpy(), atol=2e-4)
    np.testing.assert_allclose(res[0]["pgo_err"], float(jerr), rtol=1e-3)
    np.testing.assert_allclose(res[0]["pgo_err"], float(serr), rtol=1e-3)


def _jax_dist_ba(d, n_shards):
    lay = jba.shard_ba_problem(jba.BAProblem(**{
        k: jnp.asarray(v, jnp.int32) if k.endswith("idx") else jnp.asarray(v) for k, v in d.items()
    }), n_shards)
    mesh = jmake_mesh(n_cams=2, n_map=2, devices=jax.devices()[:4])
    return jba.make_distributed_ba(mesh, JIntr(*INTR), **BA_OPTS)(jnp.asarray(d["poses"]), *lay)


def test_distributed_ba_matches_reference_and_fixes_r2(mesh_run):
    """Landmarks split over each `cam` group of a 2 x 2 mesh, laid out by
    the group's size: poses within 1e-4 of the JAX package's distributed BA
    given the same layout and of the port's single-device BA, the error
    within 1e-3 px.  The reference's tracker lays the problem out by the
    whole mesh's size (4 shards for a `cam` axis of 2): its solve then
    misses the single-device one (ROADMAP R2), the port's does not."""
    args, res = mesh_run
    for r in res[1:]:
        np.testing.assert_array_equal(r["ba"], res[0]["ba"])
    d = args["ba"]
    single, serr = tba.bundle_adjust(tba.BAProblem(**{k: torch.from_numpy(v) for k, v in d.items()}),
                                     TIntr(*INTR), **BA_OPTS)
    jposes, _, jerr = _jax_dist_ba(d, 2)
    np.testing.assert_allclose(res[0]["ba"], np.asarray(jposes), atol=1e-4)
    np.testing.assert_allclose(res[0]["ba"], single.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(res[0]["ba_err"], float(jerr), atol=1e-3)
    np.testing.assert_allclose(res[0]["ba_err"], float(serr), atol=1e-3)
    wrong, _, _ = _jax_dist_ba(d, 4)
    assert np.abs(np.asarray(wrong) - single.poses.numpy()).max() > 100 * np.abs(
        res[0]["ba"] - single.poses.numpy()).max()


def test_sharded_apply_to_map_bit_identical(mesh_run):
    """Rows split over each `map` group of two: every rank holds the same
    map, bit for bit equal to one device's whole-map pass, in the port and
    in the JAX package."""
    args, res = mesh_run
    data, n, graph = args["map"]
    for r in res:
        np.testing.assert_array_equal(r["map"], res[0]["map"])
    from densemonoslam_tpu_torch.mapping import deformation as tdg

    one = tdg.apply_to_map(torch.from_numpy(data.copy()), torch.tensor(n), tdg.graph_from_numpy(graph, "cpu"))
    np.testing.assert_array_equal(res[0]["map"], one.numpy())
    jgraph = jdg.DeformGraph(**{k: jnp.asarray(v) for k, v in graph.items()})
    jout = jsharded(jmake_mesh(n_cams=2, n_map=2, devices=jax.devices()[:4]))(
        jnp.asarray(data), jnp.asarray(n, jnp.int32), jgraph)
    # the port subtracts before squaring where the XLA path expands the
    # square (ops/deform.py): the two agree to f32 rounding
    np.testing.assert_allclose(res[0]["map"], np.asarray(jout), atol=1e-5)


def test_tracker_on_mesh_matches_single_device(seq, tracker_frames, mesh_run):
    """`SparseTracker(mesh=...)` on every rank of the 2 x 2 mesh, over
    `tests/test_torch_sparse.py`'s frames (local BA and a loop closure with
    PGO, both distributed): every rank ends with the same keyframes, within
    2e-3 of the single-device tracker's, with the same BA runs and loops."""
    args, res = mesh_run
    for r in res[1:]:
        np.testing.assert_array_equal(r["trk"]["kf"], res[0]["trk"]["kf"])
    i = seq.camera.intrinsics
    trk = tsparse.SparseTracker(TIntr(i.fx, i.fy, i.cx, i.cy), device="cpu", **TRACKER)
    trk.pose = seq.gt_pose(0).astype(np.float32)
    for inten, depth in tracker_frames:
        trk.track(torch.from_numpy(inten), torch.from_numpy(depth))
    trk.flush()
    t = res[0]["trk"]
    assert t["ba_runs"] == trk.local_ba_runs >= 1 and t["loops"] == trk.loops_closed >= 1
    np.testing.assert_allclose(t["kf"], np.stack([p for _, p, _ in trk.keyframes]), atol=2e-3)
    np.testing.assert_allclose(t["pose"], trk.pose, atol=2e-3)


R3_BODY = """
from densemonoslam_tpu_torch.parallel import ba, mesh as meshmod
mesh = meshmod.make_mesh(n_cams=n)
T = torch.from_numpy
P, ei, ej, Z, w = args["pgo"]
poses, err = ba.make_distributed_pgo(mesh, cg_iters=128)(T(P), ba.PoseGraphEdges(T(ei), T(ej), T(Z), T(w)))
out["pgo"] = poses.numpy()
"""


def test_pgo_on_three_ranks_fixes_r3(tmp_path):
    """The tracker pads 8 edges to 8, a power of two, which does not split
    over a `cam` axis of 3: the reference's edge-sharded PGO refuses it
    (ROADMAP R3).  The port pads to a multiple of the group's size (9) and
    matches the single-device solve within 2e-4."""
    assert tsparse.edge_capacity(8) == 8 and tsparse.edge_capacity(8, 3) == 9
    P, ei, ej, Z, w = _pose_graph(n_edges=8)
    jrun = jba.make_distributed_pgo(jmake_mesh(n_cams=3, n_map=1, devices=jax.devices()[:3]))
    with pytest.raises(ValueError):
        jrun(jnp.asarray(P), jba.PoseGraphEdges(jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
                                                jnp.asarray(Z), jnp.asarray(w)))
    graph = _pose_graph(n_edges=tsparse.edge_capacity(8, 3))
    res = run_ranks(3, R3_BODY, dict(pgo=graph), tmp_path)
    single, _ = tba.optimise_pose_graph(
        torch.from_numpy(graph[0]), tba.PoseGraphEdges(*map(torch.from_numpy, graph[1:])), cg_iters=128)
    for r in res:
        np.testing.assert_allclose(r["pgo"], single.numpy(), atol=2e-4)
