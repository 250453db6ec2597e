"""The street lap's frames rendered on a torch device, in float64: the
same ray casts, texture and sky as `street.StreetSequence.frame`, one
frame a few milliseconds on the card where the host takes about a second.
The per-frame exposure draws stay numpy's.  Against the host render a
pixel differs at most where float64 rounding crosses a rounding or cell
boundary (held by the tests)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .street import _FAR, StreetSequence


def _texture(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * torch.sin(3.1 * x + 1.3) * torch.cos(2.3 * y) + 0.15 * torch.sin(5.7 * z)
    g = 0.5 + 0.25 * torch.cos(2.9 * y + 0.7) * torch.sin(3.7 * z) + 0.15 * torch.sin(4.3 * x + 2.0)
    b = 0.5 + 0.25 * torch.sin(2.1 * z + 2.9) * torch.cos(4.1 * x) + 0.15 * torch.cos(3.3 * y + 1.1)
    d = (
        0.15 * torch.sin(11.0 * x) * torch.sin(13.0 * y) * torch.sin(9.0 * z)
        + 0.10 * torch.sin(7.3 * x + 2.1 * y) * torch.cos(6.1 * z)
    )
    cx, cy, cz = torch.floor(x * 9.0), torch.floor(y * 9.0), torch.floor(z * 9.0)
    h = torch.sin(cx * 12.9898 + cy * 78.233 + cz * 37.719) * 43758.5453
    d = d + 0.18 * (2.0 * (h - torch.floor(h)) - 1.0)
    return torch.clamp(torch.stack([r + d, g + d, b + d], dim=-1), 0.0, 1.0)


def _sky_color(dirs: torch.Tensor) -> torch.Tensor:
    h = torch.clamp(-dirs[..., 1] / torch.clamp(torch.linalg.norm(dirs, dim=-1), min=1e-9), 0, 1)
    return torch.clamp(torch.stack([0.55 + 0.2 * h, 0.65 + 0.2 * h, 0.9 - 0.1 * h], dim=-1), 0, 1)


def _cylinder_hit(scene, o, d, R: float, outer: bool) -> torch.Tensor:
    ox, oz, dx, dz = o[..., 0], o[..., 2], d[..., 0], d[..., 2]
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - R * R
    disc = b * b - a * c
    ok = (disc > 0) & (a > 1e-12)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = ((-b + sq) if outer else (-b - sq)) / torch.clamp(a, min=1e-12)
    y = o[..., 1] + t * d[..., 1]
    ok = ok & (t > 1e-6) & (y > scene.top_y) & (y < scene.ground_y + 1e-6)
    return torch.where(ok, t, _FAR)


def _raycast(scene, origins, dirs, cam_pos: np.ndarray):
    t = torch.full(origins.shape[:-1], _FAR, dtype=torch.float64, device=origins.device)
    dy = dirs[..., 1]
    t_g = torch.where(dy > 1e-9, (scene.ground_y - origins[..., 1])
                      / torch.where(dy.abs() < 1e-12, 1e-12, dy), _FAR)
    t = torch.minimum(t, torch.where(t_g > 1e-6, t_g, _FAR))
    t = torch.minimum(t, _cylinder_hit(scene, origins, dirs, scene.r_in, outer=False))
    t = torch.minimum(t, _cylinder_hit(scene, origins, dirs, scene.r_out, outer=True))
    near = np.linalg.norm(scene.sphere_c - cam_pos[None], axis=-1) < 45.0
    d2 = torch.sum(dirs * dirs, dim=-1)
    for c, r in zip(scene.sphere_c[near], scene.sphere_r[near]):
        oc = origins - torch.as_tensor(c, device=origins.device)
        b = torch.sum(oc * dirs, dim=-1)
        cterm = torch.sum(oc * oc, dim=-1) - r * r
        disc = b * b - d2 * cterm
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_s = (-b - sq) / torch.clamp(d2, min=1e-12)
        t = torch.where((disc > 0) & (t_s > 1e-6) & (t_s < t), t_s, t)
    sky = t >= _FAR * 0.5
    points = origins + torch.where(sky, 0.0, t)[..., None] * dirs
    return t, points, sky


def frame(seq: StreetSequence, i: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """`seq.frame(i)` rendered on `device`: (rgb u8 [H,W,3], depth f32 [H,W])."""
    intr, res = seq.camera.intrinsics, seq.camera.resolution
    f64 = dict(dtype=torch.float64, device=device)
    vv, uu = torch.meshgrid(torch.arange(res.height, **f64), torch.arange(res.width, **f64),
                            indexing="ij")
    rays = torch.stack([(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy,
                        torch.ones_like(uu)], dim=-1)
    pose = torch.as_tensor(seq.poses[i], **f64)
    dirs = rays @ pose[:3, :3].T
    origins = pose[:3, 3].expand(dirs.shape)
    tt, points, sky = _raycast(seq.scene, origins, dirs, np.asarray(seq.poses[i][:3, 3]))
    depth = torch.where(sky, 0.0, tt).to(torch.float32)
    col = torch.where(sky[..., None], _sky_color(dirs), _texture(points * 0.35))
    rng = np.random.default_rng(98765 + i)
    rgbf = col * 255.0
    if seq.exposure_jitter > 0:
        gain = 1.0 + rng.normal(0.0, seq.exposure_jitter)
        bias = rng.normal(0.0, seq.exposure_jitter * 40.0)
        rgbf = rgbf * gain + bias
    rgb = torch.clamp(rgbf, 0, 255).to(torch.uint8).cpu().numpy()
    depth = depth.cpu().numpy()
    if seq.depth_noise > 0:
        depth = depth + np.where(
            depth > 0, rng.normal(0.0, 1.0, depth.shape) * seq.depth_noise * depth, 0.0
        ).astype(np.float32)
    return rgb, depth
