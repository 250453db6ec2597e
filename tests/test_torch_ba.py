"""The port's pose-graph optimisation and Schur-complement bundle adjustment
(`densemonoslam_tpu_torch.parallel.ba`) against the JAX package's
single-device solvers on the same numpy problems."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.parallel import ba as jba
from densemonoslam_tpu.utils import se3 as jse3
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.parallel import ba as tba

torch.set_num_threads(2)

INTR = (160.0, 160.0, 80.0, 60.0)


def _exp(xi):
    return np.array(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


@pytest.fixture(scope="module")
def loop_graph():
    """8 keyframes on a circle, odometry edges with noise, one loop edge
    (weight 3), the initial estimate a drifted odometry chain; padded to 16
    poses and 16 edges as the tracker pads."""
    rng = np.random.default_rng(3)
    K, Kcap, Ecap = 8, 16, 16
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        T = _exp(np.array([0.0, th, 0.0, 0.0, 0.0, 0.0]))
        T[:3, 3] = [3 * np.sin(th), 0.0, -3 * np.cos(th)]
        gt.append(T)
    edges, poses = [], [gt[0]]
    for k in range(1, K):
        Z = np.linalg.inv(gt[k - 1]) @ gt[k]
        Z = Z @ _exp(rng.normal(0, [0.01] * 3 + [0.03] * 3))
        edges.append((k - 1, k, Z, 1.0))
        poses.append(poses[-1] @ Z)
    edges.append((0, K - 1, np.linalg.inv(gt[0]) @ gt[K - 1], 3.0))
    P = np.tile(np.eye(4, dtype=np.float32), (Kcap, 1, 1))
    P[:K] = np.stack(poses)
    ei, ej = np.zeros(Ecap, np.int64), np.zeros(Ecap, np.int64)
    Z = np.tile(np.eye(4, dtype=np.float32), (Ecap, 1, 1))
    w = np.zeros(Ecap, np.float32)
    for e, (i, j, Ze, we) in enumerate(edges):
        ei[e], ej[e], Z[e], w[e] = i, j, Ze, we
    return P, ei, ej, Z, w, np.stack(gt)


def test_optimise_pose_graph_matches_reference(loop_graph):
    """Same optimum as the JAX solver within 2e-4 m / 2e-4 in the rotation
    entries (f32 CG over 8 GN steps), the same final error within 1e-3
    relative, and the loop residual actually removed."""
    P, ei, ej, Z, w, gt = loop_graph
    jout, jerr = jba.optimise_pose_graph(
        jnp.asarray(P), jba.PoseGraphEdges(jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
                                           jnp.asarray(Z), jnp.asarray(w)), cg_iters=128,
    )
    tout, terr = tba.optimise_pose_graph(
        torch.from_numpy(P), tba.PoseGraphEdges(*map(torch.from_numpy, (ei, ej, Z, w))),
        cg_iters=128,
    )
    jout, tout = np.asarray(jout), tout.numpy()
    np.testing.assert_allclose(tout[:, :3, 3], jout[:, :3, 3], atol=2e-4)
    np.testing.assert_allclose(tout[:, :3, :3], jout[:, :3, :3], atol=2e-4)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-3)
    drift0 = np.linalg.norm(P[7, :3, 3] - gt[7, :3, 3])
    assert np.linalg.norm(tout[7, :3, 3] - gt[7, :3, 3]) < 0.5 * drift0


@pytest.fixture(scope="module")
def ba_window():
    """W = 3 cameras looking down +z, 64 points with depth observations,
    pixel and depth noise, perturbed poses (the first pinned) and points."""
    rng = np.random.default_rng(5)
    fx, fy, cx, cy = INTR
    W, Pn = 3, 64
    gt = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    gt[:, 0, 3] = [0.0, 0.4, 0.8]
    gt[1] = gt[1] @ _exp(np.array([0.0, 0.03, 0.0, 0.0, 0.0, 0.0]))
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn),
                    rng.uniform(4, 8, Pn)], -1).astype(np.float32)
    cam, pnt, uv, z = [], [], [], []
    for c in range(W):
        Tinv = np.linalg.inv(gt[c])
        p = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        u = p[:, 0] / p[:, 2] * fx + cx + rng.normal(0, 0.3, Pn)
        v = p[:, 1] / p[:, 2] * fy + cy + rng.normal(0, 0.3, Pn)
        cam += [c] * Pn
        pnt += list(range(Pn))
        uv.append(np.stack([u, v], -1))
        z.append(p[:, 2] * (1 + rng.normal(0, 0.005, Pn)) * (rng.random(Pn) > 0.2))
    poses = gt.copy()
    for c in range(1, W):
        poses[c] = poses[c] @ _exp(rng.normal(0, [0.01] * 3 + [0.05] * 3))
    init_pts = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    valid = np.ones(W * Pn, bool)
    valid[::17] = False
    return dict(
        poses=poses.astype(np.float32), points=init_pts, cam_idx=np.array(cam), pnt_idx=np.array(pnt),
        uv=np.concatenate(uv).astype(np.float32), valid=valid,
        z=np.concatenate(z).astype(np.float32),
    )


def _problems(d):
    names = ("poses", "points", "cam_idx", "pnt_idx", "uv", "valid", "z")
    jp = jba.BAProblem(**{
        k: jnp.asarray(d[k], jnp.int32) if k.endswith("idx") else jnp.asarray(d[k]) for k in names
    })
    tp = tba.BAProblem(**{k: torch.from_numpy(d[k]) for k in names})
    return jp, tp


@pytest.mark.parametrize("with_depth", [True, False], ids=["rgbd", "reprojection"])
def test_bundle_adjust_matches_reference(ba_window, with_depth):
    """The tracker's settings (4 iterations, 1 pinned camera, damping 1e-2,
    Huber 3 px, 8 px pregate), and a plain reprojection problem with two
    pinned cameras: poses within 1e-4, points within 1e-3 m, mean error
    within 1e-3 px of the JAX solver."""
    jp, tp = _problems(ba_window)
    if not with_depth:
        jp, tp = jp._replace(z=None), tp._replace(z=None)
    kw = dict(iters=4, fix_cameras=1, damping=1e-2, huber=3.0, pregate_px=8.0) if with_depth \
        else dict(iters=5, fix_cameras=2)
    jres, jerr = jba.bundle_adjust(jp, JIntr(*INTR), **kw)
    tres, terr = tba.bundle_adjust(tp, TIntr(*INTR), **kw)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses), atol=1e-4)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), atol=1e-3)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-3)
    _, err0 = tba.bundle_adjust(tp, TIntr(*INTR), **{**kw, "iters": 0})
    assert float(terr) < 0.5 * float(err0)  # the solve did reduce the error


def test_ba_blocks_match_reference_jacobians(ba_window):
    """The per-observation residuals and Jacobians (reverse passes over
    per-observation variables) equal the JAX package's vmapped jacfwd to
    1e-3 relative of each block's scale."""
    d = ba_window
    jr, jJc, jJp = jba._ba_blocks(
        jnp.asarray(d["poses"]), jnp.asarray(d["points"]), jnp.asarray(d["cam_idx"], jnp.int32),
        jnp.asarray(d["pnt_idx"], jnp.int32), jnp.asarray(d["uv"]), jnp.asarray(d["valid"]),
        JIntr(*INTR), z_obs=jnp.asarray(d["z"]),
    )
    t = {k: torch.from_numpy(d[k]) for k in ("poses", "points", "cam_idx", "pnt_idx", "uv",
                                              "valid", "z")}
    tr, tJc, tJp = tba._ba_blocks(
        t["poses"], t["points"], t["cam_idx"], t["pnt_idx"], t["uv"], t["valid"], TIntr(*INTR),
        z_obs=t["z"],
    )
    for a, b in ((tr, jr), (tJc, jJc), (tJp, jJp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3 * np.abs(b).max())
