"""The process layout of collaborative multi-camera SLAM over
`torch.distributed`, and the collectives the parallel modules run on it
(port of `densemonoslam_tpu.parallel.mesh`).

The reference package lays cameras out as a `cam` axis of a device mesh and
can shard the surfel map over a second `map` axis.  Here every rank of the
process group is one cell of that ``n_cams x n_map`` grid: rank ``r`` holds
camera ``r // n_map`` and map block ``r % n_map``.  `Mesh` keeps the two
process groups a rank belongs to: its `cam` group (the ranks of every
camera that share its map block) and its `map` group (the ranks that share
its camera).

The collectives name their group and never pick a backend: NCCL takes only
CUDA tensors; gloo takes CUDA tensors for `all_reduce` and `broadcast`, and
`all_gather` copies a CUDA payload to the host and back here, in plain
sight, counted in `COUNTS` (``host_copies``, ``host_bytes``) beside the
number of each collective and the bytes it carried.  Any other combination
raises.  Each collective is a `torch.profiler` range named `collective.*`.
The reference package's `cam_sharding` and `replicated` shardings have no
counterpart: a rank simply holds its own camera's tensors.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch
import torch.distributed as dist

from densemonoslam_tpu_torch.utils import timer

COUNTS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in the ``n_cams x n_map`` grid of ranks."""

    n_cams: int
    n_map: int
    cam: int  # this rank's camera index (its rank within `cam_group`)
    map: int  # this rank's map-block index (its rank within `map_group`)
    cam_group: dist.ProcessGroup
    map_group: dist.ProcessGroup

    @property
    def shape(self) -> dict:
        return {"cam": self.n_cams, "map": self.n_map}


def make_mesh(n_cams: int | None = None, n_map: int = 1) -> Mesh:
    """The grid over the first ``n_cams * n_map`` ranks of the initialised
    default process group (all ranks on `cam` by default).  Every rank of
    the default group must call this, with the same arguments, since each
    sub-group is created collectively; the groups take the default group's
    backend."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call parallel.multihost.initialize() "
            "or torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if n_cams is None:
        n_cams = world // n_map
    if n_cams < 1 or n_map < 1 or n_cams * n_map > world:
        raise ValueError(f"a {n_cams} x {n_map} mesh does not fit {world} ranks")
    rank = dist.get_rank()
    mine = {}
    for j in range(n_map):  # one cam group per map block
        g = dist.new_group([c * n_map + j for c in range(n_cams)])
        if rank % n_map == j:
            mine["cam_group"] = g
    for c in range(n_cams):  # one map group per camera
        g = dist.new_group([c * n_map + j for j in range(n_map)])
        if rank // n_map == c:
            mine["map_group"] = g
    if rank >= n_cams * n_map:
        raise ValueError(f"rank {rank} lies outside the {n_cams} x {n_map} mesh")
    return Mesh(n_cams=n_cams, n_map=n_map, cam=rank // n_map, map=rank % n_map, **mine)


def _backend(t: torch.Tensor, group: dist.ProcessGroup, op: str) -> str:
    backend = dist.get_backend(group)
    dev = t.device.type
    if backend == "nccl" and dev == "cuda":
        return backend
    if backend == "gloo" and dev == "cpu":
        return backend
    if backend == "gloo" and dev == "cuda" and op in ("all_reduce", "broadcast", "all_gather"):
        return backend
    raise RuntimeError(f"{op} of a {dev} tensor over a {backend} group is not supported")


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] += 1
    COUNTS[op + "_bytes"] += t.numel() * t.element_size()


def all_gather(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[n, *t.shape]: every rank's `t`, in group-rank order."""
    backend = _backend(t, group, "all_gather")
    n = dist.get_world_size(group)
    _count("all_gather", t)
    t = t.contiguous()
    with timer.span("collective.all_gather"):
        if backend == "nccl":
            out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=group)
            return out
        host = t.cpu() if t.device.type == "cuda" else t
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.stack(parts)
        if t.device.type == "cuda":  # gloo gathers host tensors only
            COUNTS["host_copies"] += 2
            COUNTS["host_bytes"] += (1 + n) * t.numel() * t.element_size()
            out = out.to(t.device)
        return out


def all_reduce_sum(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of every rank's `t` (a new tensor)."""
    _backend(t, group, "all_reduce")
    _count("all_reduce", t)
    out = t.clone()
    with timer.span("collective.all_reduce"):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group: dist.ProcessGroup) -> torch.Tensor:
    """`t` of the group's rank `src`, written into `t` on every rank."""
    _backend(t, group, "broadcast")
    _count("broadcast", t)
    with timer.span("collective.broadcast"):
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t
