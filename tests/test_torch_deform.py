"""Parity of the port's deformation graph (`mapping/deformation.py`) and of
kernel K2's plain version (`ops/deform.py`) with
`densemonoslam_tpu.mapping.deformation` and with the TPU kernel itself,
`deform_points_pallas(..., interpret=True)`, on the same numpy inputs.

Sizes: graphs of at most 128 nodes, maps of a few thousand rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import cg as jax_cg

from densemonoslam_tpu.mapping import deformation as jdg
from densemonoslam_tpu.ops.pallas import deform as jpallas
from densemonoslam_tpu_torch.mapping import deformation as tdg
from densemonoslam_tpu_torch.ops import deform as tdeform

torch.set_num_threads(2)

K = 128
FIELDS = tdg.GRAPH_FIELDS


@pytest.fixture
def rng():
    """A fresh generator per test, so each test's inputs do not depend on
    which tests ran before it in the process."""
    return np.random.default_rng(0)


def _graph_np(rng, K=K, n_valid=110, identity=False):
    """Time-sorted nodes with ties, a few invalid ones inside the valid
    range and the tail invalid at +inf, as `sample_graph` lays them out."""
    pos = np.zeros((K, 3), np.float32)
    pos[:n_valid] = rng.uniform(-2, 2, (n_valid, 3))
    time = np.full(K, np.inf, np.float32)
    time[:n_valid] = np.sort(np.floor(rng.uniform(0, 60, n_valid)))
    valid = np.zeros(K, bool)
    valid[:n_valid] = rng.random(n_valid) > 0.05
    A = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    if not identity:
        A = (A + 0.03 * rng.normal(size=(K, 3, 3))).astype(np.float32)
        t = (0.02 * rng.normal(size=(K, 3))).astype(np.float32)
    return dict(pos=pos, time=time, valid=valid, A=A, t=t)


def _jgraph(g):
    return jdg.DeformGraph(**{k: jnp.asarray(g[k]) for k in FIELDS})


def _points(rng, P):
    pts = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    times = np.floor(rng.uniform(-5, 65, P)).astype(np.float32)
    nrm = rng.normal(size=(P, 3))
    return pts, times, (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)


def _map(rng, P, spare=100):
    """[P + spare + 1, 16] map: 10% dead rows, the last 50 allocated rows at
    or past `count`, every column filled."""
    pts, times, nrm = _points(rng, P)
    data = np.zeros((P + spare + 1, 16), np.float32)
    data[:P, 0:3] = pts
    data[:P, 3] = rng.uniform(0.5, 5, P) * (rng.random(P) > 0.1)
    data[:P, 4:8] = rng.uniform(0, 255, (P, 4))
    data[:P, 8:11] = nrm
    data[:P, 11] = times
    data[:P, 12:16] = rng.uniform(0, 100, (P, 4))
    return data, P - 50


def test_graph_numpy_round_trip(rng):
    g = _graph_np(rng)
    back = tdg.graph_to_numpy(tdg.graph_from_numpy(g, "cpu"))
    for k in FIELDS:
        assert back[k].dtype == g[k].dtype and np.array_equal(back[k], g[k]), k


def test_sample_graph_matches_reference(rng):
    """Node selection, stride widening and the stable time sort (many rows
    share a tick) agree exactly: the port's graph is the reference's."""
    N, n = 4096, 3000
    data = np.zeros((N + 1, 16), np.float32)
    data[:n, 0:3] = rng.normal(size=(n, 3))
    data[:n, 3] = 5.0 * (rng.random(n) > 0.2)
    data[:n, 11] = rng.integers(0, 40, n)
    for max_nodes, rate in [(64, 30), (64, 100), (16, 10)]:
        jg = jdg.sample_graph(jnp.asarray(data), jnp.asarray(n, jnp.int32), max_nodes=max_nodes,
                              sample_rate=rate)
        tg = tdg.sample_graph(torch.from_numpy(data), torch.tensor(n), max_nodes, rate)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)


def test_deform_points_matches_reference(rng):
    """Positions and normals within 2e-6 (f32 rounding of the expanded
    distance and of the blend products; the node selection is the same)."""
    g = _graph_np(rng)
    pts, times, nrm = _points(rng, 500)
    jo, jn = jdg.deform_points(_jgraph(g), jnp.asarray(pts), jnp.asarray(times), jnp.asarray(nrm))
    to, tn = tdg.deform_points(
        tdg.graph_from_numpy(g, "cpu"), torch.from_numpy(pts), torch.from_numpy(times),
        torch.from_numpy(nrm),
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-6)


def test_apply_to_poses_matches_reference(rng):
    """Deformed poses within 1e-5 (the batched SVD re-orthonormalisation)."""
    g = _graph_np(rng)
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    poses = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = rng.uniform(-2, 2, (20, 3))
    times = np.floor(rng.uniform(-5, 65, 20)).astype(np.float32)
    jp = jdg.apply_to_poses(_jgraph(g), jnp.asarray(poses), jnp.asarray(times))
    tg = tdg.graph_from_numpy(g, "cpu")
    tp = tdg.apply_to_poses(tg, torch.from_numpy(poses), torch.from_numpy(times))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    one = tdg.apply_to_pose(tg, torch.from_numpy(poses[3]), 12.0)
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jdg.apply_to_pose(_jgraph(g), jnp.asarray(poses[3]), 12.0)), atol=1e-5
    )


def test_cg_matches_jax_cg(rng):
    """`_cg` is `jax.scipy.sparse.linalg.cg` (x0 = 0, tol 1e-5): on an SPD
    system that converges before `maxiter` the stopping test freezes the
    iterate at the same point (within f32 rounding of the dot products)."""
    M = rng.normal(size=(40, 40)).astype(np.float32)
    A = M @ M.T / 40 + np.eye(40, dtype=np.float32)
    b = rng.normal(size=40).astype(np.float32)
    jx, _ = jax_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), maxiter=64)
    At = torch.from_numpy(A)
    tx = tdg._cg(lambda v: At @ v, torch.from_numpy(b), 64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)


def test_normal_products_match_func_transforms(rng):
    """`_normal_products` gives ``J^T r`` and ``(J^T J + damping) v`` equal
    (to 1e-6 relative) to `torch.func.vjp` and `torch.func.jvp` of the same
    residual."""
    g = tdg.graph_from_numpy(_graph_np(rng), "cpu")
    pts, times, _ = _points(rng, 40)
    cons = tdg.Constraint(
        src=torch.from_numpy(pts), dst=torch.from_numpy(pts + 0.05),
        time=torch.from_numpy(times), valid=torch.ones(40, dtype=torch.bool),
        pinned=torch.zeros(40, dtype=torch.bool),
    )
    frozen = g.time < 20
    w = tdg._constraint_weights(g, cons, None)

    def residual(x):
        return tdg._energy_residuals((x[: 9 * K].reshape(K, 3, 3), x[9 * K :].reshape(K, 3)),
                                     g, cons, frozen, None, w)

    x = torch.cat([g.A.reshape(-1), g.t.reshape(-1)])
    v = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    JtJv, jtr = tdg._normal_products(residual, x)
    r0, pullback = torch.func.vjp(residual, x)
    _, jv = torch.func.jvp(residual, (x,), (v,))
    ref = pullback(jv)[0] + tdg.DAMPING * v
    torch.testing.assert_close(JtJv(v), ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))
    torch.testing.assert_close(jtr, pullback(r0)[0], rtol=1e-6, atol=1e-6)


def _problem(rng):
    """(graph, constraints, frozen, relative constraints) as numpy dicts: a
    rest graph, point constraints half pulled by a few cm and half pinned,
    the oldest nodes frozen, a few carried relative pairs."""
    g = _graph_np(rng, identity=True)
    C = 60
    src, _, _ = _points(rng, C)
    ct = np.floor(rng.uniform(20, 60, C)).astype(np.float32)
    dst = src + np.array([0.0, 0.05, 0.02], np.float32)
    pinned = np.arange(C) >= C // 2
    dst[pinned] = src[pinned]
    cons = dict(src=src, dst=dst, time=ct, valid=rng.random(C) > 0.1, pinned=pinned)
    R = 8
    rsrc = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    rel = dict(src=rsrc, dst=rsrc + 0.01, src_time=np.floor(rng.uniform(20, 60, R)).astype(np.float32),
               dst_time=np.floor(rng.uniform(0, 30, R)).astype(np.float32), valid=rng.random(R) > 0.3)
    return g, cons, g["time"] < 20, rel


def test_optimise_matches_reference(rng):
    """GN-CG from one shared problem: the deformed constraint points within
    1e-4 m and the three error stats within rtol 1e-3; node parameters
    within 2e-3, since nodes away from the constraints are held only by the
    regularisers, where CG's f32 dot products summed in another order over
    3 x 64 iterations move them most; the result lies on the same side of
    the loop's acceptance gates."""
    g, cons, frozen, rel = _problem(rng)
    jcons = jdg.Constraint(**{k: jnp.asarray(v) for k, v in cons.items()})
    jrel = jdg.RelConstraint(**{k: jnp.asarray(v) for k, v in rel.items()})
    tcons = tdg.Constraint(**{k: torch.from_numpy(v) for k, v in cons.items()})
    trel = tdg.RelConstraint(**{k: torch.from_numpy(v) for k, v in rel.items()})
    jg2, js = jdg.optimise(_jgraph(g), jcons, frozen=jnp.asarray(frozen), rel=jrel)
    tg2, ts = tdg.optimise(tdg.graph_from_numpy(g, "cpu"), tcons, frozen=torch.from_numpy(frozen),
                           rel=trel)
    jax.block_until_ready(jg2)
    np.testing.assert_allclose(tg2.A.numpy(), np.asarray(jg2.A), atol=2e-3)
    np.testing.assert_allclose(tg2.t.numpy(), np.asarray(jg2.t), atol=2e-3)
    np.testing.assert_allclose([float(x) for x in ts], [float(x) for x in js], rtol=1e-3, atol=1e-7)
    src = np.concatenate([cons["src"], rel["src"], rel["dst"]])
    times = np.concatenate([cons["time"], rel["src_time"], rel["dst_time"]])
    np.testing.assert_allclose(
        tdg.deform_points(tg2, torch.from_numpy(src), torch.from_numpy(times)).numpy(),
        np.asarray(jdg.deform_points(jg2, jnp.asarray(src), jnp.asarray(times))), atol=1e-4,
    )
    for thresh in (0.01, 0.02):
        assert (float(ts.mean_cons_error) <= thresh) == (float(js.mean_cons_error) <= thresh)


def test_deform_map_reference_matches_xla_and_pallas(rng):
    """K2's plain version against both forms of the reference on one map:
    the XLA `apply_to_map` and the TPU kernel in interpret mode, positions
    and normals within 2e-6 (the kernel forms subtract before squaring, the
    XLA form expands; the nodes selected are the same).  Dead rows, rows at
    or past `count` and every other column keep their bits."""
    g = _graph_np(rng)
    data, count = _map(rng, 3000)
    jg = _jgraph(g)
    j_xla = np.asarray(jdg.apply_to_map(jnp.asarray(data), jnp.asarray(count, jnp.int32), jg))
    P = count
    j_p, j_n = jpallas.deform_points_pallas(
        jg.pos, jg.time, jg.valid, jg.A, jg.t, jnp.asarray(data[:P, 0:3]),
        jnp.asarray(data[:P, 11]), jnp.asarray(data[:P, 8:11]), interpret=True,
    )
    before = tdeform.LAUNCHES
    out = tdeform.deform_map(torch.from_numpy(data.copy()), torch.tensor(count),
                             tdg.graph_from_numpy(g, "cpu")).numpy()
    assert tdeform.LAUNCHES == before  # the CPU takes the plain version, no launch
    np.testing.assert_allclose(out, j_xla, atol=2e-6)
    alive = np.zeros(len(data), bool)
    alive[:count] = data[:count, 3] > 0
    np.testing.assert_allclose(out[:P][alive[:P], 0:3], np.asarray(j_p)[alive[:P]], atol=2e-6)
    np.testing.assert_allclose(out[:P][alive[:P], 8:11], np.asarray(j_n)[alive[:P]], atol=2e-6)
    np.testing.assert_array_equal(out[~alive], data[~alive])
    other = [3, 4, 5, 6, 7, 11, 12, 13, 14, 15]
    np.testing.assert_array_equal(out[:, other], data[:, other])


def test_deform_map_reference_matches_xla_and_pallas_shuffled_ties(rng):
    """The oracle for K2's per-thread path: rows in random order (so no run
    of neighbouring rows shares one node window) and node times with many
    ties (110 nodes over 8 ticks, rows over the same ticks), against the XLA
    `apply_to_map` and the TPU kernel in interpret mode, within 2e-6 as
    above.  The shapes are the test above's, so its compiled programs are
    reused."""
    g = _graph_np(rng)
    g["time"][:110] = np.sort(np.floor(rng.uniform(0, 8, 110)))
    data, count = _map(rng, 3000)
    data[:count, 11] = np.floor(rng.uniform(-1, 9, count))
    data[:count] = data[rng.permutation(count)]
    P = count
    jg = _jgraph(g)
    j_xla = np.asarray(jdg.apply_to_map(jnp.asarray(data), jnp.asarray(count, jnp.int32), jg))
    j_p, j_n = jpallas.deform_points_pallas(
        jg.pos, jg.time, jg.valid, jg.A, jg.t, jnp.asarray(data[:P, 0:3]),
        jnp.asarray(data[:P, 11]), jnp.asarray(data[:P, 8:11]), interpret=True,
    )
    out = tdeform.deform_map(torch.from_numpy(data.copy()), torch.tensor(count),
                             tdg.graph_from_numpy(g, "cpu")).numpy()
    np.testing.assert_allclose(out, j_xla, atol=2e-6)
    alive = np.zeros(len(data), bool)
    alive[:count] = data[:count, 3] > 0
    np.testing.assert_allclose(out[:P][alive[:P], 0:3], np.asarray(j_p)[alive[:P]], atol=2e-6)
    np.testing.assert_allclose(out[:P][alive[:P], 8:11], np.asarray(j_n)[alive[:P]], atol=2e-6)
    assert (out[alive][:, 0:3] != data[alive][:, 0:3]).any()
    np.testing.assert_array_equal(out[~alive], data[~alive])


def test_deform_map_passthrough_and_input_checks(rng):
    """An all-invalid graph passes every row through bit for bit; the
    wrapper raises on inputs the kernel does not take."""
    data, count = _map(rng, 500)
    d = torch.from_numpy(data.copy())
    c = torch.tensor(count)
    out = tdeform.deform_map(d, c, tdg.empty_graph(64, "cpu"))
    assert out is d and np.array_equal(out.numpy(), data)
    g = tdg.graph_from_numpy(_graph_np(rng), "cpu")
    bad = [
        (d[:, :15].contiguous(), c, g),  # not [N+1, 16]
        (d.double(), c, g),
        (d.T.contiguous().T, c, g),  # not contiguous
        (d, c.float(), g),
        (d, c, tdg.empty_graph(tdeform.MAX_NODES + 1, "cpu")),
        (d, c, g._replace(valid=g.valid.float())),
        (d, c, g._replace(A=g.A[:-1])),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tdeform.deform_map(*args)
