"""Whole-map embedded-deformation apply (kernel K2): every live surfel's
position and normal through the deformation graph, on each accepted loop
closure.

`deform_map(data, count, graph)` is the one entry point the port uses.  A
map on the CPU goes to `deform_map_reference`, the plain PyTorch version; a
map on the card goes to the hand-written Hopper kernel in `csrc/deform.cu`
(replacing the TPU kernel `densemonoslam_tpu.ops.pallas.deform.deform_soa_pallas`),
or the call raises.  `LAUNCHES` counts kernel launches.

Both forms update `data` IN PLACE (the reference donates the map): rows
`< count` with `conf > 0` get new positions (columns 0:3) and normals
(columns 8:11); every other byte stays as it was.  The engine's map backend
and frontend state hold this same tensor, so both see the update.

Both follow the TPU kernel's arithmetic: squared distances are formed from
the difference ``p - g`` (the reference's differentiable
`deformation.deform_points` expands ``|p|^2 - 2 p.g + |g|^2`` instead, so the
two agree to f32 rounding of that expansion, not bit for bit).
"""

from __future__ import annotations

import ctypes

import torch

from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import cuda_build

LAUNCHES = 0

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


def _declare(lib: ctypes.CDLL) -> None:
    lib.deform_map_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.deform_map_f32.restype = ctypes.c_int
    lib.deform_max_nodes.argtypes = []
    lib.deform_max_nodes.restype = ctypes.c_int
    if lib.deform_max_nodes() != MAX_NODES:
        raise RuntimeError("csrc/deform.cu and ops/deform.py disagree on MAX_NODES")


def deform_map_cuda(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
    """Launch K2 (its node-table prologue, then the map kernel) on PyTorch's
    current stream (no synchronise); returns `data`."""
    global LAUNCHES
    lib = cuda_build.load("deform", _declare)
    f32 = dict(dtype=torch.float32)
    count64 = count.to(torch.int64)
    pos = graph.pos.to(**f32).contiguous()
    time = graph.time.to(**f32).contiguous()
    valid = graph.valid.contiguous().view(torch.uint8)  # bool is one byte: no copy
    A = graph.A.to(**f32).contiguous()
    t = graph.t.to(**f32).contiguous()
    K = pos.shape[0]
    # the prologue's node table: [K, 16] floats, then n_valid
    table = torch.empty(16 * K + 4, device=data.device, **f32)
    dev = data.device.index
    err = lib.deform_map_f32(
        data.data_ptr(), data.shape[0] - 1, count64.data_ptr(), pos.data_ptr(), time.data_ptr(),
        valid.data_ptr(), A.data_ptr(), t.data_ptr(), K, table.data_ptr(), dev,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"deform kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return data


def deform_map(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
    """Deform the live rows of the `[N+1, 16]` map `data` through `graph`
    (a `deformation.DeformGraph`), in place; returns `data`.

    CPU tensors use `deform_map_reference`; CUDA tensors use the kernel
    (never a fallback).  Raises unless `data` is a contiguous f32 `[N+1, 16]`
    tensor, `count` a 0-dim integer tensor and the graph's K nodes (K <= 512)
    lie on the same device, with node times sorted ascending."""
    if data.dim() != 2 or data.shape[1] != sm.COLS or data.shape[0] < 1:
        raise ValueError(f"deform_map needs an [N+1, {sm.COLS}] map, got {tuple(data.shape)}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError(f"deform_map needs a contiguous float32 map, got {data.dtype}")
    if count.dim() != 0 or count.dtype.is_floating_point or count.dtype == torch.bool:
        raise ValueError(f"deform_map needs a 0-dim integer count, got {count.dtype} {tuple(count.shape)}")
    K = graph.pos.shape[0]
    shapes = {
        "pos": (K, 3), "time": (K,), "valid": (K,), "A": (K, 3, 3), "t": (K, 3),
    }
    for name, shape in shapes.items():
        x = getattr(graph, name)
        if tuple(x.shape) != shape:
            raise ValueError(f"graph.{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != data.device:
            raise ValueError(f"graph.{name} is on {x.device}, the map on {data.device}")
        want = torch.bool if name == "valid" else torch.float32
        if x.dtype != want:
            raise ValueError(f"graph.{name} must be {want}, got {x.dtype}")
    if not 1 <= K <= MAX_NODES:
        raise ValueError(f"deform_map supports 1..{MAX_NODES} nodes, got {K}")
    if count.device != data.device:
        raise ValueError(f"count is on {count.device}, the map on {data.device}")
    if data.device.type == "cuda":
        if data.data_ptr() % 16:
            raise ValueError("deform_map needs a 16-byte aligned map for its float4 rows")
        return deform_map_cuda(data, count, graph)
    if data.device.type == "cpu":
        return deform_map_reference(data, count, graph)
    raise ValueError(f"deform_map has no kernel for device {data.device}")
