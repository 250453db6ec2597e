"""FillIn: composite predicted model maps with live-frame data where the
prediction has holes (port of `densemonoslam_tpu.mapping.fillin`; the
passthrough and frame-to-model options, which the step does not use, are
not ported)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilledModel(NamedTuple):
    intensity: torch.Tensor  # [H,W]
    depth: torch.Tensor  # [H,W]
    vmap: torch.Tensor  # [H,W,3]
    nmap: torch.Tensor  # [H,W,3]


def fill_in(
    pred_intensity: torch.Tensor,
    pred_depth: torch.Tensor,
    pred_vmap: torch.Tensor,
    pred_nmap: torch.Tensor,
    frame_intensity: torch.Tensor,
    frame_depth: torch.Tensor,
    frame_vmap: torch.Tensor,
    frame_nmap: torch.Tensor,
) -> FilledModel:
    """Hole pixels of the prediction take the live frame's data (both in the
    same camera frame)."""
    hole = pred_depth <= 0
    take = hole & (frame_vmap[..., 2] > 0)
    return FilledModel(
        intensity=torch.where(hole, frame_intensity, pred_intensity),
        depth=torch.where(take, frame_depth, pred_depth),
        vmap=torch.where(take[..., None], frame_vmap, pred_vmap),
        nmap=torch.where(take[..., None], frame_nmap, pred_nmap),
    )
