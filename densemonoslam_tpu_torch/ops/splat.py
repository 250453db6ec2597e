"""Surfel splat rasterisation via scatter-min z-buffering (port of
`densemonoslam_tpu.ops.splat`).

1. ONE scatter-min (`scatter_reduce_(..., "amin")`) of a packed int32
   (depth-bucket, index) key per surfel centre pixel — the same key as the
   reference package, so winners agree bit for bit; maps too large for the
   packed key use the exact two-scatter path (depth, then min index);
2. ONE row-gather of the winning surfels' attributes;
3. a dense 3x3 disk resolve: each pixel adopts the nearest neighbouring-cell
   winner whose screen disk covers it;
4. depth refined by intersecting the pixel ray with the winner's tangent
   plane.

The ACTIVE tail block is gathered by index (`index_select`), not sliced, so
its data-dependent start never has to be read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import warp
from densemonoslam_tpu_torch.utils import se3
from densemonoslam_tpu_torch.utils.tensors import scalar

MODE_ACTIVE = 0  # surfels seen within the time window (tracking/fusion view)
MODE_INACTIVE = 1  # surfels older than the window (loop-closure view)
MODE_ALL = 2

_BIG_INDEX = 2**30
_FAR = 1e9
_I32_MAX = int(np.iinfo(np.int32).max)
# int32 view of the 0.05 m near-plane float (the z gate floor)
_Z_FLOOR_BITS = int(np.float32(0.05).view(np.int32))


def packed_key_params(n_rows: int, depth_max: float, windowed: bool) -> tuple[int, int] | None:
    """Static (idx_bits, shift) layout of the packed z-buffer key
    ``((bits(z) - bits(0.05)) >> shift) * 2^idx_bits + idx``, or None when
    the exact two-scatter path must be used (the reference's rules)."""
    if n_rows > (1 << 21):
        return None
    idx_bits = max(int(np.ceil(np.log2(max(n_rows, 2)))), 1) if windowed else 21
    span = int(np.float32(min(depth_max, 1e9)).view(np.int32)) - _Z_FLOOR_BITS
    shift = max(0, int(span).bit_length() - (31 - idx_bits))
    if shift > 17:  # relative tie-break error 2^(shift-23) would exceed ~1.6%
        return None
    max_key = ((span >> shift) + 1) * (1 << idx_bits) + (n_rows - 1)
    if max_key >= _I32_MAX:
        return None
    return idx_bits, shift


class Prediction(NamedTuple):
    """Predicted view of the map from a pose (camera-frame maps)."""

    index: torch.Tensor  # [H,W] int64 surfel id, -1 where empty
    vmap: torch.Tensor  # [H,W,3] camera-frame vertices (z=0 invalid)
    nmap: torch.Tensor  # [H,W,3] camera-frame normals
    color: torch.Tensor  # [H,W,3] 0..255
    intensity: torch.Tensor  # [H,W] luminance
    depth: torch.Tensor  # [H,W] z (0 invalid)
    time: torch.Tensor  # [H,W] last-seen tick of the winning surfel
    conf: torch.Tensor  # [H,W] confidence of the winning surfel
    cell: torch.Tensor  # [H,W] int64 raw per-cell z-buffer winner before the
    # disk resolve (-1 none): every surfel visible in `index` won its own
    # centre cell here, so accumulation keyed on `cell` always finds it


def active_window_start(count: torch.Tensor, capacity: int, window: int) -> torch.Tensor:
    """Start row of the active tail block (compaction keeps the layout
    [inactive..., active...], so the ACTIVE set is in the last rows)."""
    return torch.clamp(count - window, 0, max(capacity - window, 0))


def window_rows(data: torch.Tensor, start: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Copy of rows [start, start + n_rows) of `data` (device-side start)."""
    return data.index_select(0, start + torch.arange(n_rows, device=data.device))


def render(
    data: torch.Tensor,  # [N+1, 16] surfel rows (sm layout)
    count: torch.Tensor,  # [] int
    pose: torch.Tensor,  # [4,4] camera-to-world of the view to render
    intr: CameraIntrinsics,
    width: int,
    height: int,
    time: torch.Tensor | float,
    time_delta: int = 200,
    mode: int = MODE_ALL,
    splat_k: int = 3,
    depth_max: float = 100.0,
    window: int = 0,
    packed_zbuffer: bool = True,
) -> Prediction:
    """Render the surfel map from `pose`.  ACTIVE keeps surfels last seen
    within `time_delta` of `time`, INACTIVE the complement; `window` > 0
    (ACTIVE only) restricts the pass to the active tail block, while
    `Prediction.index` stays a global row index."""
    dev = data.device
    N = data.shape[0] - 1
    HW = height * width
    windowed = window > 0 and window < N and mode == MODE_ACTIVE
    if windowed:
        start = active_window_start(count, N, window)
        rows = window_rows(data, start, window)
        n_rows = window
    else:
        start = torch.zeros((), dtype=torch.int64, device=dev)
        rows = data[:-1]
        n_rows = N
    idx = torch.arange(n_rows, device=dev)
    conf = rows[:, sm.CONF]
    seen = sm.last_seen_any(rows)

    Tinv = se3.se3_inverse(pose)
    p_c = se3.transform_points(Tinv, rows[:, sm.POS])
    z = p_c[:, 2]
    zsafe = torch.clamp(z, min=1e-6)
    u = p_c[:, 0] / zsafe * intr.fx + intr.cx
    v = p_c[:, 1] / zsafe * intr.fy + intr.cy

    alive = (conf > 0) & (idx < count - start)
    t_now = scalar(time, torch.float32, dev)
    if mode == MODE_ACTIVE:
        alive = alive & (t_now - seen < time_delta)
    elif mode == MODE_INACTIVE:
        alive = alive & (t_now - seen >= time_delta)
    visible = alive & (z > 0.05) & (z < depth_max)

    ui = torch.round(u).long()
    vi = torch.round(v).long()
    inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ok = visible & inb
    tid = torch.where(ok, vi * width + ui, HW)

    pkp = packed_key_params(n_rows, depth_max, windowed) if packed_zbuffer else None
    if pkp is not None:
        idx_bits, z_shift = pkp
        zc = torch.clamp(z, 0.05, depth_max).to(torch.float32)
        depth_key = (zc.view(torch.int32) - _Z_FLOOR_BITS) >> z_shift  # int32 throughout
        key = depth_key * (1 << idx_bits) + idx.to(torch.int32)
        kbuf = torch.full((HW + 1,), _I32_MAX, dtype=torch.int32, device=dev)
        kbuf.scatter_reduce_(0, tid, torch.where(ok, key, _I32_MAX), "amin")
        win = (kbuf[:HW] & ((1 << idx_bits) - 1)).long()
        has_win = kbuf[:HW] < _I32_MAX
    else:
        zbuf = torch.full((HW + 1,), _FAR, dtype=torch.float32, device=dev)
        zbuf.scatter_reduce_(0, tid, torch.where(ok, z, _FAR), "amin")
        is_win = ok & (z <= zbuf[tid])
        ibuf = torch.full((HW + 1,), _BIG_INDEX, dtype=torch.int64, device=dev)
        ibuf.scatter_reduce_(0, tid, torch.where(is_win, idx, _BIG_INDEX), "amin")
        win = ibuf[:HW]
        has_win = win < _BIG_INDEX
    win_safe = torch.where(has_win, win, n_rows - 1)  # any in-range row; masked below
    cell_map = torch.where(has_win, start + win, -1).reshape(height, width)

    # ONE wide row-gather of the winners' attributes
    n_cam = se3.rotate_vectors(Tinv, rows[:, sm.NORMAL])
    r_px_all = torch.clamp(
        rows[:, sm.RADIUS] * intr.fx / torch.clamp(z, min=1e-6), 0.5, splat_k * 0.75
    )
    tbl = torch.cat(
        [
            u[:, None], v[:, None], z[:, None], p_c, n_cam, r_px_all[:, None],
            (start + idx).to(torch.float32)[:, None],  # global row index
            rows[:, sm.COLOR], seen[:, None], conf[:, None],
        ],
        dim=-1,
    )
    g = tbl[win_safe]  # [HW, 16]
    invalid_row = torch.zeros(16, dtype=torch.float32, device=dev)
    invalid_row[0:2].fill_(-1e9)  # fill_: a Python scalar written through a
    invalid_row[2:3].fill_(_FAR)  # 0-dim index is copied from the host
    cand = torch.where(has_win[:, None], g, invalid_row).reshape(height, width, 16)

    # dense 3x3 disk resolve
    x_pix, y_pix = warp.pixel_grid(height, width, dev)
    half = splat_k // 2
    best_z = torch.full((height, width), _FAR, dtype=torch.float32, device=dev)
    best = torch.zeros((height, width, 16), dtype=torch.float32, device=dev)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            c = warp.shift(cand, dy, dx)
            du = c[..., 0] - x_pix
            dv = c[..., 1] - y_pix
            r_px = c[..., 9]
            covers = (du * du + dv * dv) <= r_px * r_px
            # z > 0.05 also rejects the zero rows shift() pads in at borders
            valid = (c[..., 2] > 0.05) & (c[..., 2] < depth_max) & covers
            better = valid & (c[..., 2] < best_z)
            best_z = torch.where(better, c[..., 2], best_z)
            best = torch.where(better[..., None], c, best)

    valid_px = best_z < _FAR
    # ray/tangent-plane depth refinement
    ray = torch.stack(
        [(x_pix - intr.cx) / intr.fx, (y_pix - intr.cy) / intr.fy, torch.ones_like(x_pix)],
        dim=-1,
    )
    n_w = best[..., 6:9]
    p_w = best[..., 3:6]
    denom = torch.sum(ray * n_w, dim=-1)
    z_plane = torch.sum(p_w * n_w, dim=-1) / torch.where(
        torch.abs(denom) > 0.05, denom, float("inf")
    )
    z_c = best[..., 2]
    r_m = best[..., 9] * torch.clamp(z_c, min=1e-6) / intr.fx
    z_ref = torch.where(torch.abs(z_plane - z_c) < 2.0 * r_m + 1e-3, z_plane, z_c)
    z_out = torch.where(valid_px, z_ref, 0.0)

    vp = valid_px[..., None]
    vmap = torch.where(vp, ray * z_out[..., None], 0.0)
    nmap = torch.where(vp, n_w, 0.0)
    color = torch.where(vp, best[..., 11:14], 0.0)
    return Prediction(
        index=torch.where(valid_px, best[..., 10].long(), -1),
        vmap=vmap,
        nmap=nmap,
        color=color,
        intensity=0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2],
        depth=z_out,
        time=torch.where(valid_px, best[..., 14], -1.0),
        conf=torch.where(valid_px, best[..., 15], 0.0),
        cell=cell_map,
    )
