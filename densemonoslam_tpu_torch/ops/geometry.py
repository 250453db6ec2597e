"""Camera-geometry ops: back-projection, normal maps, projection and bounds
(port of the parts of `densemonoslam_tpu.ops.geometry` the open-loop path
uses).

Conventions: vertex maps are [H, W, 3] with invalid pixels marked by z == 0;
normal maps are [H, W, 3] unit vectors, invalid = all zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics


def backproject(depth: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Depth [H,W] (metres, 0 = invalid) -> camera-frame vertex map [H,W,3]."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project(
    points: torch.Tensor, intr: CameraIntrinsics
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points [..., 3] -> (u, v, z) pixel coordinates."""
    z = points[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = points[..., 0] / zsafe * intr.fx + intr.cx
    v = points[..., 1] / zsafe * intr.fy + intr.cy
    return u, v, z


def normal_map(vmap: torch.Tensor) -> torch.Tensor:
    """Central-difference normals from a vertex map (zero where the support is
    invalid, and on the one-pixel border, where the neighbours wrap)."""
    right = torch.roll(vmap, -1, dims=1)
    left = torch.roll(vmap, 1, dims=1)
    down = torch.roll(vmap, -1, dims=0)
    up = torch.roll(vmap, 1, dims=0)
    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    valid = (
        (vmap[..., 2] > 0)
        & (right[..., 2] > 0)
        & (left[..., 2] > 0)
        & (down[..., 2] > 0)
        & (up[..., 2] > 0)
        & (norm[..., 0] > 1e-12)
    )
    n = torch.where(valid[..., None], n / torch.clamp(norm, min=1e-12), torch.zeros_like(n))
    for border in (n[0, :], n[-1, :], n[:, 0], n[:, -1]):
        border.fill_(0.0)
    return n


def in_bounds(u: torch.Tensor, v: torch.Tensor, W: int, H: int, margin: int = 0) -> torch.Tensor:
    return (u >= margin) & (u <= W - 1 - margin) & (v >= margin) & (v <= H - 1 - margin)
