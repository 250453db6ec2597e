"""Collaborative multi-camera SLAM: one camera per rank of a `torch.distributed`
process group (port of `densemonoslam_tpu.parallel.collab`).

Each rank runs the full per-frame step (`step.make_device_step`: one CUDA
graph on the card) on its own camera
and map; the cameras' stats rows are all-gathered over the mesh's `cam`
group, so every rank sees the whole session's health, and the map sizes are
summed.  Intra-map loop closure runs on each rank at the caller's cadence
(`make_collab_local_loop`, kernel K2 in an accepted closure), with the small
outcome vectors all-gathered so every rank sees which cameras closed.
"""

from __future__ import annotations

from typing import Optional

import torch

from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.parallel import mesh as meshmod

# the collaborative state is this rank's camera's `step.SlamState`
CollabState = stepmod.SlamState

DEFAULT_CONFIG = dict(
    max_surfels=1 << 14, depth_cutoff=100.0, depth_factor=1.0, nid_keyframing=False,
    open_loop=True,
)


def init_state(
    capacity: int, height: int, width: int, device: torch.device | str = "cuda"
) -> CollabState:
    """This rank's camera's empty state."""
    return stepmod.init_state(capacity, height, width, device=device)


def init_rel_banks(capacity: int = 64, device: torch.device | str = "cuda") -> loopsmod.RelBank:
    """This rank's camera's bank of carried relative constraints."""
    return loopsmod.make_rel_bank(capacity, device=device)


def make_collab_step(
    mesh: meshmod.Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: Optional[EngineConfig] = None,
):
    """`collab_step(state, rgb, depth) -> (state, stats [n_cams, 29], total)`:
    this rank's step on its own frame, the session's stats rows gathered in
    camera order, and the surfels of all cameras' maps (0-dim, replicated)."""
    cfg = config or EngineConfig(**DEFAULT_CONFIG)
    steps = {}  # by device: the step is captured for the state it first sees

    def collab_step(state: CollabState, rgb: torch.Tensor, depth: torch.Tensor):
        dev = state.map_data.device
        if dev not in steps:
            steps[dev] = stepmod.make_device_step(intr, height, width, cfg, 0, dev)
        state, stats = steps[dev](
            state, torch.as_tensor(rgb, device=dev), torch.as_tensor(depth, device=dev),
            torch.eye(4, dtype=torch.float32, device=dev), False, 1.0, 0.0,
        )
        # one gather for the stats row and the map size
        rows = meshmod.all_gather(
            torch.cat([stats, state.map_count.to(torch.float32).reshape(1)]), mesh.cam_group
        )
        total = rows[:, -1].sum().to(torch.int64)
        return state, rows[:, :-1], total

    return collab_step


def make_collab_local_loop(
    mesh: meshmod.Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
):
    """Per-camera intra-map loop closure on every rank
    (`loops.try_local_loop`: INACTIVE render, model-to-model tracking, the
    gates, the deformation graph and, on acceptance, kernel K2 over the
    map), with the outcome vectors gathered.

    Returns `loop_round(state, bank) -> (state, bank, infos [n_cams, 5])`,
    columns (closed, inactive_frac, inlier_frac, icp_error, cons_error)."""
    camera = CameraConfig(FrameResolution(width, height), intr, "collab")

    def loop_round(state: CollabState, bank: loopsmod.RelBank):
        state, info, _graph, bank = loopsmod.try_local_loop(state, camera, config, rel_bank=bank)
        vec = torch.tensor(
            [float(info.closed), info.inactive_frac, info.inlier_frac, info.icp_error,
             info.cons_error], dtype=torch.float32,
        ).to(state.map_data.device)
        return state, bank, meshmod.all_gather(vec, mesh.cam_group)

    return loop_round
