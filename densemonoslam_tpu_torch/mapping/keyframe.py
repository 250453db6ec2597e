"""NID keyframes and the fusion gate (port of
`densemonoslam_tpu.mapping.keyframe`): each frame's NID against the active
keyframe decides whether it is novel enough to fuse.
Score = ndw * NID_depth + (1 - ndw) * NID_img against the 0.85 threshold."""

from __future__ import annotations

from typing import NamedTuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import geometry, histogram, warp
from densemonoslam_tpu_torch.utils import se3


class KeyFrame(NamedTuple):
    """Snapshot of the view at the keyframe pose."""

    pose: torch.Tensor  # [4,4] camera-to-world
    intensity: torch.Tensor  # [H,W]
    depth: torch.Tensor  # [H,W] z-depth


def nid_against_keyframe(
    kf: KeyFrame,
    cur_intensity: torch.Tensor,
    cur_vmap: torch.Tensor,  # [H,W,3] current camera-frame vertices
    cur_pose: torch.Tensor,
    intr: CameraIntrinsics,
    depth_max: float,
    bins_img: int = 64,
    bins_depth: int = 500,
    stride: int = 2,
):
    """Warp the stride-decimated current frame into the keyframe view and
    return (nid_img, nid_depth, overlap_fraction)."""
    lv = max(stride.bit_length() - 1, 0)  # stride must be a power of two
    cur_intensity = warp.decimate(cur_intensity, stride)
    cur_vmap = warp.decimate(cur_vmap, stride)
    kf_int = warp.decimate(kf.intensity, stride)
    kf_dep = warp.decimate(kf.depth, stride)
    intr = intr.scaled(lv)
    H, W = cur_intensity.shape
    A = se3.se3_inverse(kf.pose) @ cur_pose  # current cam -> kf cam
    v_flat = cur_vmap.reshape(-1, 3)
    p_kf = se3.transform_points(A, v_flat)
    u, v, z = geometry.project(p_kf, intr)
    inb = geometry.in_bounds(u, v, W, H) & (z > 0) & (v_flat[:, 2] > 0)
    ui = torch.clamp(torch.round(u), 0, W - 1).long()
    vi = torch.clamp(torch.round(v), 0, H - 1).long()
    flat = vi * W + ui
    i_kf = kf_int.reshape(-1)[flat]
    d_kf = kf_dep.reshape(-1)[flat]
    valid = inb & (d_kf > 0)
    n_img = histogram.nid_image(cur_intensity.reshape(-1), i_kf, valid, bins=bins_img)
    n_depth = histogram.nid_depth(z, d_kf, valid, depth_max, bins=bins_depth)
    overlap = valid.to(torch.float32).mean()
    return n_img, n_depth, overlap


def nid_score(n_img: torch.Tensor, n_depth: torch.Tensor, depth_weight: float) -> torch.Tensor:
    """Combined score (reference `ElasticFusion.cpp:657-673`)."""
    return depth_weight * n_depth + (1.0 - depth_weight) * n_img
