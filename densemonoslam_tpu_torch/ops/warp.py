"""Image decimation, static shifts and small-displacement sampling (port of
`densemonoslam_tpu.ops.warp`).

The reference package resolves small per-pixel displacements with a stack of
statically shifted images, because gathers serialise on a TPU.  A GPU gathers
at memory speed, so `sample_*_local` here are plain gathers that keep the
reference's out-of-range semantics exactly: a tap outside the (2R+1)^2 shift
stack or outside the image contributes zero.
"""

from __future__ import annotations

from typing import Tuple

import torch


def decimate(img: torch.Tensor, k: int) -> torch.Tensor:
    """``img[::k, ::k]`` for [H, W] and [H, W, C]."""
    if k == 1:
        return img
    return img[::k, ::k]


def shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static shift with zero fill: out[y, x] = img[y+dy, x+dx] (0 outside)."""
    H, W = img.shape[0], img.shape[1]
    out = torch.zeros_like(img)
    ys, ye = max(-dy, 0), H - max(dy, 0)
    xs, xe = max(-dx, 0), W - max(dx, 0)
    if ys < ye and xs < xe:
        out[ys:ye, xs:xe] = img[ys + dy : ye + dy, xs + dx : xe + dx]
    return out


def _tap(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor, radius: int) -> torch.Tensor:
    """img[y+sy, x+sx] per pixel; zero where the offset leaves the shift stack
    (|s| > radius) or the target leaves the image."""
    H, W = img.shape[0], img.shape[1]
    y = torch.arange(H, device=img.device)[:, None] + sy
    x = torch.arange(W, device=img.device)[None, :] + sx
    ok = (
        (sy.abs() <= radius) & (sx.abs() <= radius)
        & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    )
    val = img[y.clamp(0, H - 1), x.clamp(0, W - 1)]
    return torch.where(ok[..., None], val, torch.zeros_like(val))


def sample_nearest_local(
    img: torch.Tensor,  # [H, W, C]
    du: torch.Tensor,  # [H, W] x-displacement (float pixels)
    dv: torch.Tensor,  # [H, W]
    radius: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour sample of img at (x + du, y + dv) per pixel.

    Returns (sampled [H,W,C], valid [H,W]); displacements beyond `radius`
    are invalid and sample to zero, as are targets outside the image."""
    i0 = torch.round(du).long()
    j0 = torch.round(dv).long()
    valid = (i0.abs() <= radius) & (j0.abs() <= radius)
    return _tap(img, j0, i0, radius), valid


def sample_bilinear_local(
    img: torch.Tensor,  # [H, W, C]
    du: torch.Tensor,
    dv: torch.Tensor,
    radius: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of img at (x + du, y + dv) per pixel; valid only when
    all four corner taps lie within the shift stack.  Corner taps outside
    the stack or the image contribute zero (the reference's tent-weighted
    sum over the shift stack)."""
    i0 = torch.floor(du).long()
    j0 = torch.floor(dv).long()
    valid = (i0 >= -radius) & (i0 <= radius - 1) & (j0 >= -radius) & (j0 <= radius - 1)
    acc = torch.zeros_like(img)
    for oy in (0, 1):
        for ox in (0, 1):
            sx, sy = i0 + ox, j0 + oy
            w = torch.clamp(1.0 - torch.abs(du - sx.to(du.dtype)), 0.0, 1.0) * torch.clamp(
                1.0 - torch.abs(dv - sy.to(dv.dtype)), 0.0, 1.0
            )
            acc = acc + w[..., None] * _tap(img, sy, sx, radius)
    return acc, valid


def pixel_grid(
    height: int, width: int, device: torch.device | str = "cpu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) pixel coordinate images."""
    x = torch.arange(width, dtype=torch.float32, device=device).expand(height, width)
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    return x, y
