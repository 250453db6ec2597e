"""Frame preprocessing: depth conversion, bilateral filter, pyramids,
intensity and Sobel gradients (port of `densemonoslam_tpu.ops.preprocess`).

Stencils are written as sums of edge-clamped shifted images in the same
order as the reference package, so the two agree to f32 rounding.
All image tensors are [H, W] or [H, W, C], f32, row-major.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch.ops import warp


def metricise_depth(depth_raw: torch.Tensor, depth_factor: float, depth_cutoff: float) -> torch.Tensor:
    """Raw sensor units -> metres, zeroing out-of-range readings."""
    d = depth_raw.to(torch.float32) / depth_factor
    return torch.where((d > 0.0) & (d < depth_cutoff), d, torch.zeros_like(d))


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (u8 or f32 [H,W,3]) -> luminance f32 [H,W] in [0,255]."""
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y+dy), clamp(x+dx)] (replicate border)."""
    H, W = img.shape[0], img.shape[1]
    if dy:
        rows = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
        img = img.index_select(0, rows)
    if dx:
        cols = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
        img = img.index_select(1, cols)
    return img


def bilateral_filter_depth(
    depth: torch.Tensor,
    radius: int = 2,
    sigma_space: float = 4.5,
    sigma_depth: float = 0.03,
) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window; invalid (0)
    depths contribute zero weight and pixels without support stay 0."""
    valid = (depth > 0.0).to(torch.float32)
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            d_n = _shifted(depth, dy, dx)
            v_n = _shifted(valid, dy, dx)
            w_s = float(np.exp(-(dx * dx + dy * dy) / (2.0 * sigma_space**2)))
            diff = d_n - depth
            w_d = torch.exp(-(diff * diff) / (2.0 * sigma_depth**2))
            w = w_s * w_d * v_n
            acc = acc + w * d_n
            wacc = wacc + w
    out = torch.where(wacc > 1e-6, acc / torch.clamp(wacc, min=1e-6), torch.zeros_like(acc))
    return out * valid


_GAUSS_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _sep_conv(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable convolution with replicate borders via shifted adds."""
    r = len(k) // 2
    tmp = torch.zeros_like(img)
    for i, w in enumerate(k):
        tmp = tmp + float(w) * _shifted(img, 0, i - r)
    out = torch.zeros_like(img)
    for i, w in enumerate(k):
        out = out + float(w) * _shifted(tmp, i - r, 0)
    return out


def pyr_down_gauss(img: torch.Tensor) -> torch.Tensor:
    """Gaussian 5-tap blur + 2x decimation."""
    return warp.decimate(_sep_conv(img, _GAUSS_5), 2)


def pyr_down_depth(depth: torch.Tensor, sigma_depth: float = 0.03) -> torch.Tensor:
    """Depth-aware 2x downsample: Gaussian weights over the 5x5 support, but
    only samples within a depth band of the centre, ignoring invalid zeros."""
    centre = warp.decimate(depth, 2)
    acc = torch.zeros_like(centre)
    wacc = torch.zeros_like(centre)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            n = warp.decimate(_shifted(depth, dy, dx), 2)
            w_s = float(_GAUSS_5[dy + 2] * _GAUSS_5[dx + 2])
            ok = (n > 0.0) & (torch.abs(n - centre) < 3.0 * sigma_depth)
            w = w_s * ok.to(torch.float32)
            acc = acc + w * n
            wacc = wacc + w
    return torch.where(
        (centre > 0.0) & (wacc > 1e-6), acc / torch.clamp(wacc, min=1e-6), torch.zeros_like(acc)
    )


def build_pyramid(img: torch.Tensor, levels: int, depth: bool = False) -> Tuple[torch.Tensor, ...]:
    """Coarse-to-fine pyramid, level 0 = input resolution."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down_depth(out[-1]) if depth else pyr_down_gauss(out[-1]))
    return tuple(out)


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y derivative images with the 1/8 normalisation."""
    s = _shifted
    gx = (
        (s(img, -1, 1) + 2.0 * s(img, 0, 1) + s(img, 1, 1))
        - (s(img, -1, -1) + 2.0 * s(img, 0, -1) + s(img, 1, -1))
    ) * 0.125
    gy = (
        (s(img, 1, -1) + 2.0 * s(img, 1, 0) + s(img, 1, 1))
        - (s(img, -1, -1) + 2.0 * s(img, -1, 0) + s(img, -1, 1))
    ) * 0.125
    return gx, gy
