"""Whole-map embedded-deformation apply, plain: every live surfel's position
and normal through the deformation graph, in 64K-row chunks, as the
program's kernel K2 computes it (squared distances formed from ``p - g``,
the 4 nearest of 20 temporal candidates, nodes accumulated nearest first).
Rows `< count` with `conf > 0` get new positions (columns 0:3) and normals
(columns 8:11); every other byte stays as it was."""

from __future__ import annotations

import torch

from . import surfel_map as sm

MAX_NODES = 512  # the node table the kernel stages in shared memory
LOOKBACK = 20  # temporal candidate window
NEAREST = 5  # 4 blend nodes + the normaliser
_CHUNK = 1 << 16  # rows per step of the plain version (bounds its [rows, 20, 3] gather)


def _node_table(graph) -> torch.Tensor:
    """[K, 12] per-node ``[A row-major 9 | c 3]`` with c_k = g_k + t_k - A_k g_k."""
    K = graph.pos.shape[0]
    c = graph.pos + graph.t - torch.einsum("kij,kj->ki", graph.A, graph.pos)
    return torch.cat([graph.A.reshape(K, 9), c], dim=-1)


def deform_map_reference(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
    """Plain PyTorch version of K2 (same selection, weights and blend), in
    place on `data`; returns `data`.  Processes the map in 64K-row chunks."""
    N = data.shape[0] - 1
    K = graph.pos.shape[0]
    dev = data.device
    n_valid = graph.valid.sum()
    top = torch.clamp(n_valid - LOOKBACK, min=0)
    tab = _node_table(graph)
    offs = torch.arange(LOOKBACK, device=dev)
    for s in range(0, N, _CHUNK):
        e = min(s + _CHUNK, N)
        rows = data[s:e]
        p, nrm, tau = rows[:, sm.POS], rows[:, sm.NORMAL], rows[:, sm.INIT_TIME]
        ins = torch.searchsorted(graph.time, tau.contiguous(), right=True)
        start = torch.minimum(torch.clamp(ins - LOOKBACK, min=0), top)
        cand = start[:, None] + offs  # [P, 20], ascending node index
        cc = torch.clamp(cand, max=K - 1)
        ok = (cand < n_valid) & graph.valid[cc]
        g = graph.pos[cc]  # [P, 20, 3]
        dx = p[:, None, 0] - g[..., 0]
        dy = p[:, None, 1] - g[..., 1]
        dz = p[:, None, 2] - g[..., 2]
        d2 = torch.where(ok, dx * dx + dy * dy + dz * dz, float("inf"))
        # stable: among equal distances the lower node index comes first
        d2s, order = torch.sort(d2, dim=1, stable=True)
        d = torch.sqrt(torch.clamp(d2s[:, :NEAREST], min=0.0))
        dmax = torch.clamp(d[:, NEAREST - 1 :], min=1e-6)
        w = torch.square(1.0 - d[:, : NEAREST - 1] / dmax)
        w = torch.where(torch.isfinite(d[:, : NEAREST - 1]), w, 0.0)
        wsum = w.sum(dim=1, keepdim=True)
        w = w / torch.clamp(wsum, min=1e-9)
        sel = torch.gather(cc, 1, order[:, : NEAREST - 1])
        # the kernel's order: nodes accumulated nearest first, rows of the
        # blended affine applied term by term
        b = w[:, 0:1] * tab[sel[:, 0]]  # [P, 12]
        for q in range(1, NEAREST - 1):
            b = b + w[:, q : q + 1] * tab[sel[:, q]]
        new_p = torch.stack(
            [b[:, 3 * i] * p[:, 0] + b[:, 3 * i + 1] * p[:, 1] + b[:, 3 * i + 2] * p[:, 2] + b[:, 9 + i]
             for i in range(3)], dim=-1,
        )
        new_n = torch.stack(
            [b[:, 3 * i] * nrm[:, 0] + b[:, 3 * i + 1] * nrm[:, 1] + b[:, 3 * i + 2] * nrm[:, 2]
             for i in range(3)], dim=-1,
        )
        norm = torch.sqrt(new_n[:, 0] ** 2 + new_n[:, 1] ** 2 + new_n[:, 2] ** 2)
        new_n = new_n / torch.clamp(norm, min=1e-9)[:, None]
        idx = torch.arange(s, e, device=dev)
        write = ((rows[:, sm.CONF] > 0) & (idx < count) & (wsum[:, 0] > 1e-9))[:, None]
        data[s:e, sm.POS] = torch.where(write, new_p, p)
        data[s:e, sm.NORMAL] = torch.where(write, new_n, nrm)
    return data


def deform_map(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
    """Deform the live rows of `data` through `graph`, in place (the plain
    version on every device); returns `data`."""
    return deform_map_reference(data, count, graph)
