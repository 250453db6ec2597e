"""Map-axis sharding: a whole-map pass split over the mesh's `map` group
(port of `densemonoslam_tpu.parallel.map_shard`).

Deformation of every surfel (kernel K2, `ops.deform.deform_map`) is the
pass: the graph is tiny and replicated, rows deform independently, so each
rank of the `map` group deforms its contiguous block of rows and one
all-gather assembles the map.
"""

from __future__ import annotations

import torch

from densemonoslam_tpu_torch.ops import deform
from densemonoslam_tpu_torch.parallel import mesh as meshmod


def make_sharded_apply_to_map(mesh: meshmod.Mesh):
    """`run(data [N+1, 16], count, graph) -> data`, in place on `data` as
    `deformation.apply_to_map`, with the N rows block-split over the `map`
    group (N must divide by its size).  K2 deforms each row alone and its
    two paths give the same bits, so the result equals one rank's K2 over
    the whole map bit for bit."""

    def run(data: torch.Tensor, count: torch.Tensor, graph) -> torch.Tensor:
        N = data.shape[0] - 1
        if N % mesh.n_map:
            raise ValueError(f"{N} map rows do not split over {mesh.n_map} ranks")
        n_local = N // mesh.n_map
        base = mesh.map * n_local
        # this rank's block as an [n_local + 1, 16] view (its last row is
        # not touched: K2 only writes rows below the block's own count)
        block = data[base : base + n_local + 1]
        local_count = torch.clamp(count - base, 0, n_local)
        deform.deform_map(block, local_count, graph)
        data[:-1] = meshmod.all_gather(block[:-1], mesh.map_group).reshape(N, -1)
        return data

    return run
