"""Pose-graph optimisation and Schur-complement bundle adjustment, on one
device or split over the ranks of a mesh's `cam` group (port of
`densemonoslam_tpu.parallel.ba`).

- **Pose graph** (`optimise_pose_graph`): keyframe poses + relative SE(3)
  edges (odometry + loop closures).  Gauss-Newton with conjugate gradient
  on ``(JtJ + lambda I) v``, the same masked CG as the deformation graph
  (x0 = 0, tol 1e-5).  Each edge residual ``r_e = log(Z_e^-1 T_i^-1 T_j)``
  touches two poses, so J is kept as its two 6x6 blocks per edge, taken by
  six reverse passes over per-edge copies of the perturbations; a CG
  product is then two gathers, four batched 6x6 products and two one-hot
  products (the reference forms the same operator as jvp + vjp through
  the residual).  Pose 0 is pinned by a strong prior row block.
- **Bundle adjustment** (`bundle_adjust`): cameras + 3D points + pixel (and
  depth) observations.  Per-observation Jacobians come from R reverse passes
  over per-observation perturbation variables (each observation has its own
  copy, so a pass yields one residual row of every observation's Jacobian,
  as the reference's vmapped `jacfwd` does).  The landmark block-diagonal is
  inverted pointwise and the camera system is the Schur complement
  ``S = U - W V^-1 W^T``.

Every per-point and per-camera sum is a product with a one-hot incidence
matrix, never a scatter-add: float atomics would make two runs on the card
differ in their last bits.  Inverses and solves use the `_ex` forms, which
do not read the device to check for errors.

The distributed forms (`make_distributed_pgo`, `make_distributed_ba`) run
the same solves over the edges or points one rank holds, with each product,
system and error all-reduced over the group; the all-reduce sums the
ranks' partials in another order than one device's sum, so the two agree to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.mapping import deformation as dg
from densemonoslam_tpu_torch.parallel import mesh as meshmod
from densemonoslam_tpu_torch.utils import se3

PGO_DAMPING = 1e-6
PGO_GN_ITERS = 8
PGO_CG_ITERS = 64


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # [E] int64 source keyframe
    j: torch.Tensor  # [E] int64 target keyframe
    Z: torch.Tensor  # [E, 4, 4] measured T_i^-1 T_j
    weight: torch.Tensor  # [E]


def _apply_xi(poses: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-perturb every pose: T_k <- T_k @ exp(xi_k)."""
    return torch.einsum("kij,kjl->kil", poses, se3.se3_exp(xi))


def _edge_residuals(xi: torch.Tensor, poses: torch.Tensor, edges: PoseGraphEdges) -> torch.Tensor:
    T = _apply_xi(poses, xi)
    Zinv = se3.se3_inverse(edges.Z)
    Tii = se3.se3_inverse(T[edges.i])
    rel = torch.einsum("eij,ejk,ekl->eil", Zinv, Tii, T[edges.j])
    r = se3.se3_log(rel)  # [E, 6]
    # gauge: pin pose 0 with a strong prior row block
    anchor = xi[0] * 100.0
    return torch.cat([(r * edges.weight[:, None]).reshape(-1), anchor])


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _pgo_normal_products(poses: torch.Tensor, edges: PoseGraphEdges, reduce=_same):
    """(v -> (JtJ + PGO_DAMPING I) v, J^T r) at xi = 0, v flat [K*6]: the
    per-edge Jacobian blocks (wrt the source and target perturbations) from
    six reverse passes over per-edge copies of the two perturbations.
    `reduce` sums the edges' share of each product over the ranks that hold
    the other edges (identity on one device)."""
    K, E = poses.shape[0], edges.i.shape[0]
    dev = poses.device
    Zinv = se3.se3_inverse(edges.Z)
    with torch.enable_grad():
        a = torch.zeros((E, 6), dtype=torch.float32, device=dev, requires_grad=True)
        b = torch.zeros((E, 6), dtype=torch.float32, device=dev, requires_grad=True)
        Ti = poses[edges.i] @ se3.se3_exp(a)
        Tj = poses[edges.j] @ se3.se3_exp(b)
        rel = torch.einsum("eij,ejk,ekl->eil", Zinv, se3.se3_inverse(Ti), Tj)
        r = se3.se3_log(rel) * edges.weight[:, None]  # [E, 6]
        rows = [torch.autograd.grad(r[:, c].sum(), (a, b), retain_graph=c < 5) for c in range(6)]
    Ji = torch.stack([ga for ga, _ in rows], dim=1)  # [E, 6 (residual), 6]
    Jj = torch.stack([gb for _, gb in rows], dim=1)
    r = r.detach()
    Hi = _one_hot(edges.i, K).T  # [K, E]
    Hj = _one_hot(edges.j, K).T
    anchor = torch.zeros((K, 1), dtype=torch.float32, device=dev)
    anchor[0].fill_(100.0 * 100.0)  # the prior rows xi[0] * 100

    def JtJv(v: torch.Tensor) -> torch.Tensor:
        v = v.reshape(K, 6)
        Jv = torch.einsum("erc,ec->er", Ji, v[edges.i]) + torch.einsum("erc,ec->er", Jj, v[edges.j])
        out = reduce(Hi @ torch.einsum("erc,er->ec", Ji, Jv) + Hj @ torch.einsum("erc,er->ec", Jj, Jv))
        return (out + anchor * v + PGO_DAMPING * v).reshape(-1)

    g = reduce(Hi @ torch.einsum("erc,er->ec", Ji, r) + Hj @ torch.einsum("erc,er->ec", Jj, r))
    return JtJv, g.reshape(-1)


def optimise_pose_graph(
    poses: torch.Tensor,  # [K, 4, 4]
    edges: PoseGraphEdges,
    iters: int = PGO_GN_ITERS,
    cg_iters: int = PGO_CG_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose-graph GN on the poses' device.  Each step is taken only if it
    lowers the error.  Returns (poses, final_error); no host reads."""
    return _pgo(poses, edges, iters, cg_iters, _same)


def _pgo(poses, edges: PoseGraphEdges, iters: int, cg_iters: int, reduce):
    """`optimise_pose_graph` over the edges this device holds; `reduce` sums
    each product and error over the devices that hold the others."""
    K = poses.shape[0]
    xi0 = torch.zeros((K, 6), dtype=torch.float32, device=poses.device)

    def err(p: torch.Tensor) -> torch.Tensor:
        return reduce(torch.sum(torch.square(_edge_residuals(xi0, p, edges))))

    with torch.no_grad():
        e = err(poses)
        for _ in range(iters):
            JtJv, g = _pgo_normal_products(poses, edges, reduce)
            dx = dg._cg(JtJv, -g, cg_iters)
            cand = _apply_xi(poses, dx.reshape(K, 6))
            e_new = err(cand)
            poses = torch.where(e_new < e, cand, poses)
            e = torch.minimum(e_new, e)
    return poses, e


class BAProblem(NamedTuple):
    poses: torch.Tensor  # [K, 4, 4] camera-to-world
    points: torch.Tensor  # [P, 3] world
    cam_idx: torch.Tensor  # [O] int64
    pnt_idx: torch.Tensor  # [O] int64
    uv: torch.Tensor  # [O, 2] observed pixels
    valid: torch.Tensor  # [O] bool
    # optional per-observation measured depth (metres; 0 = none): each
    # observation then adds a depth residual in pixel-equivalent units
    # (fx/z-weighted), which makes scale and the along-ray landmark position
    # observable under forward motion
    z: Optional[torch.Tensor] = None


def _project(pose: torch.Tensor, X: torch.Tensor, intr: CameraIntrinsics):
    """Batched [O,4,4] poses, [O,3] points -> (pixels [O,2], camera points)."""
    Tinv = se3.se3_inverse(pose)
    p = torch.einsum("oij,oj->oi", Tinv[:, :3, :3], X) + Tinv[:, :3, 3]
    z = torch.clamp(p[:, 2], min=1e-6)
    return torch.stack([p[:, 0] / z * intr.fx + intr.cx, p[:, 1] / z * intr.fy + intr.cy], -1), p


def _ba_blocks(poses, points, cam_idx, pnt_idx, uv, valid, intr, z_obs=None):
    """Per-observation residuals + Jacobians wrt the camera twist (right
    perturbation) and the point position.  Returns (r [O,R], Jc [O,R,6],
    Jp [O,R,3]) with R = 2 (reprojection) or 3 (+ the fx/z-weighted depth
    when `z_obs` is given)."""
    O = cam_idx.shape[0]
    dev = poses.device
    pose = poses[cam_idx]
    X = points[pnt_idx]
    with torch.enable_grad():
        xi = torch.zeros((O, 6), dtype=torch.float32, device=dev, requires_grad=True)
        dX = torch.zeros((O, 3), dtype=torch.float32, device=dev, requires_grad=True)
        proj, p = _project(pose @ se3.se3_exp(xi), X + dX, intr)
        r = proj - uv
        if z_obs is not None:
            has_z = (z_obs > 0).to(torch.float32)
            wz = intr.fx / torch.clamp(z_obs, min=0.5)  # metres -> pixel-equivalent
            r = torch.cat([r, ((p[:, 2] - z_obs) * wz * has_z)[:, None]], dim=1)
        rows = [
            torch.autograd.grad(r[:, c].sum(), (xi, dX), retain_graph=c + 1 < r.shape[1])
            for c in range(r.shape[1])
        ]
    m = valid.to(torch.float32)
    Jc = torch.stack([gc for gc, _ in rows], dim=1)
    Jp = torch.stack([gp for _, gp in rows], dim=1)
    return r.detach() * m[:, None], Jc * m[:, None, None], Jp * m[:, None, None]


def reproj_errors(problem: BAProblem, intr: CameraIntrinsics) -> torch.Tensor:
    """[O] per-observation residual norm at the current estimate (gates
    outlier matches out of a problem before solving)."""
    r, _, _ = _ba_blocks(
        problem.poses, problem.points, problem.cam_idx, problem.pnt_idx, problem.uv,
        problem.valid, intr, z_obs=problem.z,
    )
    return torch.linalg.norm(r, dim=-1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _schur_reduce(r, Jc, Jp, cam_idx, pnt_idx, K, Pn, damping):
    """The Schur-complement camera system from per-observation blocks.

    Per-point sums (V, b_p, the camera coupling G) and per-camera sums (U,
    b_c) are products with one-hot incidences; S's reduction is one matrix
    product over (point, coordinate)."""
    O = r.shape[0]
    dev = r.device
    Hp = _one_hot(pnt_idx, Pn).T  # [P, O]
    Hc = _one_hot(cam_idx, K)  # [O, K]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    V = (Hp @ torch.einsum("oij,oik->ojk", Jp, Jp).reshape(O, 9)).reshape(Pn, 3, 3)
    V = V + damping * eye3
    b_p = Hp @ torch.einsum("oij,oi->oj", Jp, r)
    Vinv = torch.linalg.inv_ex(V)[0]
    # per-point stacked camera coupling G [P, K, 6, 3]
    JcT_Jp = torch.einsum("oij,oik->ojk", Jc, Jp).reshape(O, 1, 18)
    G = (Hp @ (Hc[:, :, None] * JcT_Jp).reshape(O, K * 18)).reshape(Pn, K, 6, 3)
    # U is block-diagonal: each observation sees one camera
    Ud = (Hc.T @ torch.einsum("oij,oil->ojl", Jc, Jc).reshape(O, 36)).reshape(K, 6, 6)
    U = torch.zeros((K, 6, K, 6), dtype=torch.float32, device=dev)
    ar = torch.arange(K, device=dev)
    U[ar, :, ar, :] = Ud
    b_c = Hc.T @ torch.einsum("oij,oi->oj", Jc, r)
    # S = U - G Vinv G^T (block form)
    GV = torch.einsum("pkjl,plm->pkjm", G, Vinv)
    GV_rows = GV.permute(1, 2, 0, 3).reshape(K * 6, Pn * 3)
    S_red = GV_rows @ G.permute(0, 3, 1, 2).reshape(Pn * 3, K * 6)
    S = U.reshape(K * 6, K * 6) - S_red
    b = (b_c.reshape(K * 6) - GV_rows @ b_p.reshape(Pn * 3))
    return S, b, Vinv, b_p, G


def bundle_adjust(
    problem: BAProblem,
    intr: CameraIntrinsics,
    iters: int = 5,
    damping: float = 1e-4,
    fix_cameras: int = 1,
    huber: float = 0.0,
    pregate_px: float = 0.0,
) -> Tuple[BAProblem, torch.Tensor]:
    """Schur-complement BA on the problem's device.  Returns (problem, mean
    residual norm); no host reads.

    `fix_cameras` pins the first N camera blocks (1 fixes the 6-DoF gauge);
    `huber` > 0 applies a Huber IRLS weight (px) per observation;
    `pregate_px` > 0 invalidates observations whose error at the initial
    estimate exceeds the gate."""
    return _ba(problem, intr, iters, damping, fix_cameras, huber, pregate_px, _same)


def _ba(problem: BAProblem, intr, iters, damping, fix_cameras, huber, pregate_px, reduce):
    """`bundle_adjust` over the points (and all their observations) this
    device holds; `reduce` sums the Schur system and the error over the
    devices that hold the other points."""
    K = problem.poses.shape[0]
    Pn = problem.points.shape[0]
    dev = problem.poses.device
    if pregate_px > 0:
        problem = problem._replace(valid=problem.valid & (reproj_errors(problem, intr) < pregate_px))
    eye = torch.eye(K * 6, dtype=torch.float32, device=dev)
    pin = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
    pin[: 6 * fix_cameras].fill_(1e6)
    poses, points = problem.poses, problem.points
    for _ in range(iters):
        r, Jc, Jp = _ba_blocks(
            poses, points, problem.cam_idx, problem.pnt_idx, problem.uv, problem.valid, intr,
            z_obs=problem.z,
        )
        if huber > 0:
            w = torch.sqrt(torch.clamp(
                huber / torch.clamp(torch.linalg.norm(r, dim=-1), min=1e-9), max=1.0
            ))
            r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
        S, b, Vinv, b_p, G = _schur_reduce(
            r, Jc, Jp, problem.cam_idx, problem.pnt_idx, K, Pn, damping
        )
        Sb = reduce(torch.cat([S.reshape(-1), b]))  # one reduction for both
        S = Sb[: K * 6 * K * 6].reshape(K * 6, K * 6) + damping * eye + torch.diag(pin)
        b = Sb[K * 6 * K * 6 :]
        dx = torch.linalg.solve_ex(S, -b)[0].reshape(K, 6)
        poses_n = _apply_xi(poses, dx)
        # back-substitute the landmarks: dX = -Vinv (b_p + G^T dx)
        Gt_dx = torch.einsum("pkjm,kj->pm", G, dx)
        points = points - torch.einsum("pij,pj->pi", Vinv, b_p + Gt_dx)
        poses = poses_n
    r, _, _ = _ba_blocks(
        poses, points, problem.cam_idx, problem.pnt_idx, problem.uv, problem.valid, intr,
        z_obs=problem.z,
    )
    err, n = reduce(torch.stack(
        [torch.sum(torch.linalg.norm(r, dim=-1)), problem.valid.sum().to(torch.float32)]
    ))
    return problem._replace(poses=poses, points=points), err / torch.clamp(n, min=1.0)


# ---------------------------------------------------------------------------
# Distributed solves over a mesh's `cam` group (one `torch.distributed` rank
# per shard).  Every rank passes the same full inputs and solves its shard;
# the partial systems are all-reduced, so every rank holds the same poses.
# ---------------------------------------------------------------------------


def _shard(x: torch.Tensor, mesh: meshmod.Mesh) -> torch.Tensor:
    """This rank's contiguous block of `x`'s rows (of `mesh.n_cams`)."""
    n = x.shape[0] // mesh.n_cams
    return x[mesh.cam * n : (mesh.cam + 1) * n]


def make_distributed_pgo(mesh: meshmod.Mesh, iters: int = PGO_GN_ITERS, cg_iters: int = PGO_CG_ITERS):
    """Edge-sharded pose-graph GN: poses replicated, edges split over the
    `cam` group (E must divide by its size), every product and error
    all-reduced: `cg_iters` + 1 all-reduces per GN step, and one per error.

    Returns `run(poses, edges) -> (poses, final_error)`."""
    def reduce(x: torch.Tensor) -> torch.Tensor:
        return meshmod.all_reduce_sum(x, mesh.cam_group)

    def run(poses: torch.Tensor, edges: PoseGraphEdges):
        E = edges.i.shape[0]
        if E % mesh.n_cams:
            raise ValueError(f"{E} edges do not split over {mesh.n_cams} ranks: pad them")
        local = PoseGraphEdges(*(_shard(x, mesh) for x in edges))
        return _pgo(poses, local, iters, cg_iters, reduce)

    return run


def make_distributed_ba(
    mesh: meshmod.Mesh, intr: CameraIntrinsics, iters: int = 5, damping: float = 1e-4,
    fix_cameras: int = 1, huber: float = 0.0, pregate_px: float = 0.0,
):
    """Landmark-sharded Schur BA over the `cam` group: each rank owns a
    block of points and all their observations (lay them out with
    `shard_ba_problem`), forms its partial (S, b), and the all-reduced
    camera system is solved on every rank; points back-substitute locally.

    Returns `run(poses, points, cam_idx, pnt_idx_local, uv, valid, z) ->
    (poses, points, mean residual)` on the full shard-major arrays, as
    `shard_ba_problem` lays them out (the points come back gathered)."""
    def reduce(x: torch.Tensor) -> torch.Tensor:
        return meshmod.all_reduce_sum(x, mesh.cam_group)

    def run(poses, points, cam_idx, pnt_idx_local, uv, valid, z):
        local = BAProblem(
            poses=poses, points=_shard(points, mesh), cam_idx=_shard(cam_idx, mesh),
            pnt_idx=_shard(pnt_idx_local, mesh), uv=_shard(uv, mesh),
            valid=_shard(valid, mesh), z=_shard(z, mesh),
        )
        out, err = _ba(local, intr, iters, damping, fix_cameras, huber, pregate_px, reduce)
        pts = meshmod.all_gather(out.points, mesh.cam_group).reshape(-1, 3)
        return out.poses, pts, err

    return run


def shard_ba_problem(problem: BAProblem, n_shards: int, obs_align: int = 256):
    """Host-side layout for `make_distributed_ba` (numpy in, numpy out):
    observations sorted by point id, the points padded to a multiple of
    `n_shards`, each shard an equal slab of observations of exactly its
    point block (local point indices), padded to a common count rounded up
    to `obs_align`.

    Returns (points [P', 3], cam_idx, pnt_idx_local, uv, valid, z), each
    flattened shard-major."""
    import numpy as np

    points_in = np.asarray(problem.points, np.float32)
    Pn = points_in.shape[0]
    per = -(-Pn // n_shards)
    points = np.zeros((per * n_shards, 3), np.float32)
    points[:Pn] = points_in
    pnt = np.asarray(problem.pnt_idx)
    order = np.argsort(pnt, kind="stable")
    cam_s, pnt_s = np.asarray(problem.cam_idx)[order], pnt[order]
    uv_s, val_s = np.asarray(problem.uv)[order], np.asarray(problem.valid)[order]
    z_all = np.zeros(order.shape[0], np.float32) if problem.z is None else np.asarray(problem.z)
    z_s = z_all[order]
    sels = [(pnt_s >= s * per) & (pnt_s < (s + 1) * per) & val_s for s in range(n_shards)]
    o_max = max(max(int(sel.sum()) for sel in sels), 1)
    o_max = -(-o_max // obs_align) * obs_align
    cam_pad = np.zeros((n_shards, o_max), np.int64)
    pnt_pad = np.zeros((n_shards, o_max), np.int64)
    uv_pad = np.zeros((n_shards, o_max, 2), np.float32)
    val_pad = np.zeros((n_shards, o_max), bool)
    z_pad = np.zeros((n_shards, o_max), np.float32)
    for s, sel in enumerate(sels):
        n = int(sel.sum())
        cam_pad[s, :n] = cam_s[sel]
        pnt_pad[s, :n] = pnt_s[sel] - s * per
        uv_pad[s, :n] = uv_s[sel]
        val_pad[s, :n] = True
        z_pad[s, :n] = z_s[sel]
    return (
        points, cam_pad.reshape(-1), pnt_pad.reshape(-1), uv_pad.reshape(-1, 2),
        val_pad.reshape(-1), z_pad.reshape(-1),
    )
