"""Embedded deformation graph for non-rigid map correction on loop closure
(port of `densemonoslam_tpu.mapping.deformation`).

Sumner-style embedded deformation over a time-ordered node sequence sampled
from the surfel map (1 node per `sample_rate` surfels), k=4 temporal
neighbour connectivity, and the energy

    E = w_rot * E_rot + w_reg * E_reg + w_con * E_con   (weights 1, 10, 100)

with 12 variables per node (3x3 A + translation t).  `optimise` solves the
normal equations matrix-free: Gauss-Newton whose ``(JtJ + lambda I) v``
products are ``vjp(jvp(residual))`` (autograd, `_normal_products`) on a flat
[K*12] parameter vector, inside a conjugate-gradient solve that reproduces
`jax.scipy.sparse.linalg.cg` (x0 = 0, tol 1e-5, atol 0) with a fixed 64
iterations whose update is masked off once the stopping test holds, so the
solve never reads the device.  `optimise_graphed` runs it on the card as
one CUDA graph per problem shape, as the reference jits it.

Vertices and poses blend over the k nearest of a 20-node temporal look-back
window.  The whole-map apply is kernel K2 (`ops.deform`); everything else
here is plain PyTorch on either device, as the reference leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import surfel_map as sm
from . import deform
from . import plain as graphs, se3
from .tensors import scalar

W_ROT = 1.0
W_REG = 10.0
W_CON = 100.0
GN_ITERS = 3
CG_ITERS = 64
CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default
K_NEIGHBOURS = 4
LOOKBACK = 20  # temporal candidate window for blending weights
DAMPING = 1e-4


class DeformGraph(NamedTuple):
    pos: torch.Tensor  # [K, 3] node positions (world)
    time: torch.Tensor  # [K] node timestamps (sorted ascending, invalid last at +inf)
    valid: torch.Tensor  # [K] bool
    A: torch.Tensor  # [K, 3, 3] per-node affine (identity at rest)
    t: torch.Tensor  # [K, 3] per-node translation

    @property
    def n_nodes(self) -> int:
        return self.pos.shape[0]


class Constraint(NamedTuple):
    """Point constraints: deform src (+ its timestamp) onto dst."""

    src: torch.Tensor  # [C, 3]
    dst: torch.Tensor  # [C, 3]
    time: torch.Tensor  # [C]
    valid: torch.Tensor  # [C] bool
    pinned: torch.Tensor  # [C] bool: dst side also constrained to not move


class RelConstraint(NamedTuple):
    """Relative constraints: both endpoints deform and the energy holds their
    deformed positions together (``phi(src) - phi(dst)`` rows at the same
    sqrt(w_con) weight), so later closures do not undo earlier ones."""

    src: torch.Tensor  # [R, 3] deformed source positions at emission time
    dst: torch.Tensor  # [R, 3] the constraint targets they were pulled onto
    src_time: torch.Tensor  # [R]
    dst_time: torch.Tensor  # [R]
    valid: torch.Tensor  # [R] bool


GRAPH_FIELDS = DeformGraph._fields


def empty_rel(capacity: int, device: torch.device | str = "cuda") -> RelConstraint:
    f32 = dict(dtype=torch.float32, device=device)
    return RelConstraint(
        src=torch.zeros((capacity, 3), **f32),
        dst=torch.zeros((capacity, 3), **f32),
        src_time=torch.zeros((capacity,), **f32),
        dst_time=torch.zeros((capacity,), **f32),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _identity_nodes(K: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    A = torch.eye(3, dtype=torch.float32, device=device).expand(K, 3, 3).clone()
    return A, torch.zeros((K, 3), dtype=torch.float32, device=device)


def sample_graph(
    data: torch.Tensor, count: torch.Tensor, max_nodes: int, sample_rate: int
) -> DeformGraph:
    """Every `sample_rate`-th allocated surfel as a node, the stride widened
    when `max_nodes * sample_rate < count` so the nodes span the whole map;
    the nodes are sorted by creation time (stably: many surfels share one
    tick), invalid nodes last."""
    dev = data.device
    last = data.shape[0] - 2
    stride = torch.clamp(count // max_nodes + 1, min=sample_rate)
    idx = torch.arange(max_nodes, device=dev) * stride
    ok = (idx < count) & (data[torch.clamp(idx, max=last), sm.CONF] > 0)
    rows = data[torch.clamp(idx, max=last)]
    time = torch.where(ok, rows[:, sm.INIT_TIME], float("inf"))
    order = torch.argsort(time, stable=True)
    pos, time, ok = rows[order][:, sm.POS], time[order], ok[order]
    A, t = _identity_nodes(max_nodes, dev)
    return DeformGraph(pos=torch.where(ok[:, None], pos, 0.0), time=time, valid=ok, A=A, t=t)


def _window_start(graph: DeformGraph, times: torch.Tensor):
    """(first candidate node per point, n_valid): the LOOKBACK-node window
    ending at each point's insertion point in the node times, clamped into
    the valid range."""
    n_valid = graph.valid.sum()
    ins = torch.searchsorted(graph.time, times.contiguous(), right=True)
    start = torch.minimum(
        torch.clamp(ins - LOOKBACK, min=0), torch.clamp(n_valid - LOOKBACK, min=0)
    )
    return start, n_valid


def _sumner_weights(d: torch.Tensor) -> torch.Tensor:
    """[P, k+1] ascending distances -> normalised [P, k] weights
    ``(1 - d/dmax)^2``, zero where a point has no support."""
    dmax = torch.clamp(d[:, -1:], min=1e-6)
    w = torch.square(1.0 - d[:, :-1] / dmax)
    w = torch.where(torch.isfinite(d[:, :-1]), w, 0.0)
    wsum = w.sum(dim=-1, keepdim=True)
    has = wsum[:, 0] > 1e-9
    return torch.where(has[:, None], w / torch.clamp(wsum, min=1e-9), 0.0)


def _nearest(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k+1 smallest distances of each row, ascending, and their column
    indices; the lower index comes first on ties (as `jax.lax.top_k`)."""
    ds, order = torch.sort(d, dim=-1, stable=True)
    return ds[:, : K_NEIGHBOURS + 1], order[:, : K_NEIGHBOURS + 1]


def _blend_weights(
    graph: DeformGraph, points: torch.Tensor, times: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node indices [P, k], weights [P, k]) over the temporal look-back
    window; weights are zero where the graph has no valid support."""
    K = graph.n_nodes
    start, n_valid = _window_start(graph, times)
    cand = torch.clamp(start[:, None] + torch.arange(LOOKBACK, device=points.device), max=K - 1)
    cand_ok = (cand < n_valid) & graph.valid[cand]
    d = torch.linalg.norm(graph.pos[cand] - points[:, None, :], dim=-1)
    d = torch.where(cand_ok, d, float("inf"))
    dk, top = _nearest(d)
    w = _sumner_weights(dk)
    return torch.gather(cand, 1, top[:, :-1]), w


def _blend_weights_full(
    graph: DeformGraph, points: torch.Tensor, times: torch.Tensor
) -> torch.Tensor:
    """[P, K] dense k-NN blending weights (zero outside the k nearest of the
    temporal look-back window), with squared distances in the expanded form
    ``|p|^2 - 2 p.g + |g|^2`` of the reference."""
    K = graph.n_nodes
    start, n_valid = _window_start(graph, times)
    j = torch.arange(K, device=points.device)
    mask = (
        (j[None, :] >= start[:, None])
        & (j[None, :] < start[:, None] + LOOKBACK)
        & (j[None, :] < n_valid)
        & graph.valid[None, :]
    )
    d2 = (
        torch.sum(points * points, dim=-1, keepdim=True)
        - 2.0 * points @ graph.pos.T
        + torch.sum(graph.pos * graph.pos, dim=-1)[None, :]
    )
    d = torch.where(mask, torch.sqrt(torch.clamp(d2, min=0.0)), float("inf"))
    dk, top = _nearest(d)
    w = _sumner_weights(dk)
    return torch.zeros((points.shape[0], K), dtype=torch.float32, device=points.device).scatter_(
        1, top[:, :-1], w
    )


def _deform_with_weights(
    w_full: torch.Tensor, A: torch.Tensor, t: torch.Tensor, pos: torch.Tensor,
    points: torch.Tensor, normals: Optional[torch.Tensor] = None,
):
    """phi(p) = (sum_k w_k A_k) p + sum_k w_k (g_k + t_k - A_k g_k) for given
    dense weights; points without support pass through."""
    K = pos.shape[0]
    A_blend = (w_full @ A.reshape(K, 9)).reshape(-1, 3, 3)
    c = pos + t - torch.einsum("kij,kj->ki", A, pos)
    out = torch.einsum("pij,pj->pi", A_blend, points) + w_full @ c
    has = (w_full.sum(dim=-1) > 1e-9)[:, None]
    out = torch.where(has, out, points)
    if normals is None:
        return out
    n_out = torch.einsum("pij,pj->pi", A_blend, normals)
    n_out = n_out / torch.clamp(torch.linalg.norm(n_out, dim=-1, keepdim=True), min=1e-9)
    return out, torch.where(has, n_out, normals)


def deform_points(
    graph: DeformGraph,
    points: torch.Tensor,
    times: torch.Tensor,
    normals: Optional[torch.Tensor] = None,
):
    """phi(p) = sum_k w_k [A_k (p - g_k) + g_k + t_k]; points with no valid
    support pass through unchanged.  Optionally co-rotates normals.
    Differentiable in `graph.A` and `graph.t`."""
    w_full = _blend_weights_full(graph, points, times)
    return _deform_with_weights(w_full, graph.A, graph.t, graph.pos, points, normals)


def _energy_residuals(
    params: Tuple[torch.Tensor, torch.Tensor],
    graph: DeformGraph,
    cons: Constraint,
    frozen: torch.Tensor,
    rel: Optional[RelConstraint] = None,
    weights: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """All energy residual blocks, flattened (6 rot rows + 3*k reg rows per
    node, 3 rows per constraint, the frozen-node penalties, 3 rows per
    relative constraint).  `weights` are the constraints' dense blending
    weights (cons, then rel src and dst), which depend on the graph's nodes
    but not on `params`; computed here when not given."""
    A, t = params
    K = graph.n_nodes
    dev = A.device
    vmask = graph.valid.to(torch.float32)
    if weights is None:
        weights = _constraint_weights(graph, cons, rel)

    # E_rot: orthonormality of each node's affine (6 upper-triangle rows)
    AtA = torch.einsum("kji,kjl->kil", A, A)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    iu, ju = torch.triu_indices(3, 3, device=dev)
    r_rot = (AtA - eye)[:, iu, ju] * vmask[:, None]  # [K, 6]

    # E_reg: sequential neighbourhood smoothness (3 rows per edge)
    o = torch.arange(4, device=dev)
    offsets = torch.where(o < 2, o - 2, o - 1)  # -2, -1, 1, 2
    ar = torch.arange(K, device=dev)
    nb = torch.clamp(ar[:, None] + offsets[None, :], 0, K - 1)  # [K, 4]
    edge_ok = vmask[:, None] * graph.valid[nb].to(torch.float32) * (nb != ar[:, None]).to(
        torch.float32
    )
    g_j = graph.pos[:, None, :]
    g_k = graph.pos[nb]
    pred = torch.einsum("kij,knj->kni", A, g_k - g_j) + g_j + t[:, None, :]
    r_reg = (pred - (g_k + t[nb])) * edge_ok[..., None]

    # E_con: point constraints through the blend (3 rows each)
    moved = _deform_with_weights(weights[0], A, t, graph.pos, cons.src)
    r_con = (moved - cons.dst) * cons.valid.to(torch.float32)[:, None]

    # frozen old nodes: heavy penalty rows on their parameters
    fr = frozen.to(torch.float32)
    r_frozen_t = t * fr[:, None] * 10.0
    r_frozen_A = (A - eye).reshape(K, 9) * fr[:, None] * 10.0

    blocks = [
        math.sqrt(W_ROT) * r_rot.reshape(-1),
        math.sqrt(W_REG) * r_reg.reshape(-1),
        math.sqrt(W_CON) * r_con.reshape(-1),
        math.sqrt(W_CON) * r_frozen_t.reshape(-1),
        math.sqrt(W_ROT) * r_frozen_A.reshape(-1),
    ]
    if rel is not None:
        # relative rows: phi(src) - phi(dst), both endpoints deformable
        moved_s = _deform_with_weights(weights[1], A, t, graph.pos, rel.src)
        moved_d = _deform_with_weights(weights[2], A, t, graph.pos, rel.dst)
        r_rel = (moved_s - moved_d) * rel.valid.to(torch.float32)[:, None]
        blocks.append(math.sqrt(W_CON) * r_rel.reshape(-1))
    return torch.cat(blocks)


def _constraint_weights(
    graph: DeformGraph, cons: Constraint, rel: Optional[RelConstraint]
) -> Tuple[torch.Tensor, ...]:
    w = (_blend_weights_full(graph, cons.src, cons.time),)
    if rel is not None:
        w += (
            _blend_weights_full(graph, rel.src, rel.src_time),
            _blend_weights_full(graph, rel.dst, rel.dst_time),
        )
    return w


class OptimiseStats(NamedTuple):
    initial_error: torch.Tensor
    final_error: torch.Tensor
    mean_cons_error: torch.Tensor  # mean 2-norm of constraint residuals


def _cg(matvec, b: torch.Tensor, maxiter: int, tol: float = CG_TOL) -> torch.Tensor:
    """`jax.scipy.sparse.linalg.cg(matvec, b, maxiter=maxiter)` with x0 = 0,
    atol = 0 and no preconditioner: the same alpha/beta updates and stopping
    test (gamma <= tol^2 |b|^2), run for `maxiter` iterations with the update
    masked off once the test holds."""
    atol2 = tol * tol * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b  # b - A(x0) with x0 = 0
    p = r
    gamma = torch.dot(r, r)
    for _ in range(maxiter):
        run = gamma > atol2
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = torch.dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(run, x_new, x)
        r = torch.where(run, r_new, r)
        p = torch.where(run, p_new, p)
        gamma = torch.where(run, gamma_new, gamma)
    return x


def _normal_products(residual, x: torch.Tensor):
    """(v -> (JtJ + DAMPING I) v, J^T r) of `residual` at `x`.

    ``JtJ v = vjp(jvp(v))`` as in the reference, with the jvp taken as the
    transpose of a vjp: J^T u is linear in u, so differentiating it once
    more in u gives J v.  Both products then run as autograd backward
    passes over graphs recorded once per Gauss-Newton step, instead of a
    forward-mode trace of the residual in every CG iteration; the products
    equal `torch.func.jvp` followed by `torch.func.vjp` (held by
    `tests/test_torch_deform.py`)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        r = residual(xg)
        u = torch.zeros_like(r, requires_grad=True)
        (jtu,) = torch.autograd.grad(r, xg, grad_outputs=u, create_graph=True)
        (g,) = torch.autograd.grad(r, xg, grad_outputs=r.detach(), retain_graph=True)

    def JtJv(v: torch.Tensor) -> torch.Tensor:
        (jv,) = torch.autograd.grad(jtu, u, grad_outputs=v, retain_graph=True)
        (jtjv,) = torch.autograd.grad(r, xg, grad_outputs=jv, retain_graph=True)
        return jtjv + DAMPING * v

    return JtJv, g


def optimise(
    graph: DeformGraph,
    cons: Constraint,
    frozen: Optional[torch.Tensor] = None,
    iters: int = GN_ITERS,
    cg_iters: int = CG_ITERS,
    rel: Optional[RelConstraint] = None,
) -> Tuple[DeformGraph, OptimiseStats]:
    """Gauss-Newton with matrix-free CG on the normal equations (<= 3 GN
    iterations, frozen old nodes), each step backtracked over alpha in
    {1, 1/2, 1/4}: the best of them, or no step if none improves.  `rel`
    carries relative constraints from previous accepted deformations.  No
    host reads."""
    K = graph.n_nodes
    dev = graph.pos.device
    if frozen is None:
        frozen = torch.zeros((K,), dtype=torch.bool, device=dev)
    weights = _constraint_weights(graph, cons, rel)
    nA = K * 9

    def residual(x: torch.Tensor) -> torch.Tensor:
        params = (x[:nA].reshape(K, 3, 3), x[nA:].reshape(K, 3))
        return _energy_residuals(params, graph, cons, frozen, rel, weights)

    def total_err(x: torch.Tensor) -> torch.Tensor:
        r = residual(x)
        return torch.sum(r * r)

    with torch.no_grad():
        x = torch.cat([graph.A.reshape(-1), graph.t.reshape(-1)])
        e0 = total_err(x)
        for _ in range(iters):
            JtJv, g = _normal_products(residual, x)
            dx = _cg(JtJv, -g, cg_iters)
            best, e_best = x, total_err(x)
            for alpha in (1.0, 0.5, 0.25):
                cand = x + alpha * dx
                e_cand = total_err(cand)
                take = e_cand < e_best
                best = torch.where(take, cand, best)
                e_best = torch.minimum(e_cand, e_best)
            x = best
        e1 = total_err(x)
        A, t = x[:nA].reshape(K, 3, 3), x[nA:].reshape(K, 3)
        moved = _deform_with_weights(weights[0], A, t, graph.pos, cons.src)
        valid = cons.valid.to(torch.float32)
        ce = torch.sum(torch.linalg.norm(moved - cons.dst, dim=-1) * valid) / torch.clamp(
            valid.sum(), min=1.0
        )
    out = graph._replace(A=A.clone(), t=t.clone())
    return out, OptimiseStats(initial_error=e0, final_error=e1, mean_cons_error=ce)


def apply_to_map(data: torch.Tensor, count: torch.Tensor, graph: DeformGraph) -> torch.Tensor:
    """Deform every live surfel's position and normal, IN PLACE on `data`
    (returned): kernel K2 on the card, its plain version on the CPU
    (`ops.deform.deform_map`)."""
    return deform.deform_map(data, count, graph)


def empty_graph(max_nodes: int, device: torch.device | str = "cuda") -> DeformGraph:
    """An all-invalid graph: `deform_points`/`apply_to_pose*` pass
    everything through unchanged."""
    A, t = _identity_nodes(max_nodes, device)
    return DeformGraph(
        pos=torch.zeros((max_nodes, 3), dtype=torch.float32, device=device),
        time=torch.full((max_nodes,), float("inf"), dtype=torch.float32, device=device),
        valid=torch.zeros((max_nodes,), dtype=torch.bool, device=device),
        A=A,
        t=t,
    )


def apply_to_poses(graph: DeformGraph, poses: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Deform a pose history [P, 4, 4] with per-pose timestamps [P]: the
    position goes through phi, the rotation takes the blended node affine,
    re-orthonormalised by SVD.  Poses without support pass through."""
    times = times.to(torch.float32)
    p = poses[:, :3, 3].contiguous()
    nn, w = _blend_weights(graph, p, times)
    A_blend = torch.sum(w[:, :, None, None] * graph.A[nn], dim=1)
    has = w.sum(dim=-1) > 1e-9
    new_p = deform_points(graph, p, times)
    R_new = se3.orthonormalise(A_blend @ poses[:, :3, :3])
    out = poses.clone()
    out[:, :3, 3] = torch.where(has[:, None], new_p, p)
    out[:, :3, :3] = torch.where(has[:, None, None], R_new, poses[:, :3, :3])
    return out


def apply_to_pose(graph: DeformGraph, pose: torch.Tensor, time) -> torch.Tensor:
    """Deform one camera pose [4, 4] taken at `time` (`apply_to_poses`)."""
    t = scalar(time, torch.float32, pose.device)
    return apply_to_poses(graph, pose[None], t[None])[0]


def graph_from_numpy(d: Dict[str, np.ndarray], device: torch.device | str) -> DeformGraph:
    """A graph from numpy arrays keyed by the `DeformGraph` field names (e.g.
    `np.asarray` of each field of the reference's graph)."""
    return DeformGraph(**{
        k: torch.from_numpy(np.array(d[k])).to(
            device=device, dtype=torch.bool if k == "valid" else torch.float32
        )
        for k in GRAPH_FIELDS
    })


def graph_to_numpy(graph: DeformGraph) -> Dict[str, np.ndarray]:
    """Export a graph as numpy arrays in the reference's dtypes."""
    return {k: getattr(graph, k).detach().cpu().numpy() for k in GRAPH_FIELDS}
