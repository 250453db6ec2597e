"""Surfel fusion: data association, weighted-average update, inline clean and
new-surfel insertion (port of `densemonoslam_tpu.mapping.fusion`).

The update pass is pull-based, as in the reference package: each pixel
publishes its weighted contribution into a dense payload image, the 3x3
neighbourhood of every z-buffer cell is summed into that cell, and every
surfel gathers its own centre cell once.  New surfels are appended at
``count + rank`` by a direct index write (`place_updates`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .config import CameraIntrinsics
from . import surfel_map as sm
from . import splat, warp
from . import se3
from .tensors import scalar

# association gates (reference `data.vert`: depth window +-0.05, normals)
DEPTH_GATE = 0.05
NORMAL_DOT_GATE = 0.5
RADIUS_OBLIQUE_CLAMP = 0.5
# fuse only when the new radius < 1.5x the old (reference update.vert)
RADIUS_FUSE_FACTOR = 1.5
UNSTABLE_TTL = 20
FREE_SPACE_MARGIN = 0.1


class FuseStats(NamedTuple):
    matched: torch.Tensor  # pixels fused into existing surfels
    added: torch.Tensor  # new surfels created
    culled: torch.Tensor  # surfels removed by the inline clean
    dropped: torch.Tensor  # insertions discarded by the capacity headroom guard


def sample_confidence(u, v, intr: CameraIntrinsics, weight_mult) -> torch.Tensor:
    """Per-pixel fusion weight: Gaussian in radial distance from the
    principal point (reference `surfels.glsl` confidence())."""
    sigma = 0.6 * max(intr.cx, intr.cy) * 2.0
    r2 = (u - intr.cx) ** 2 + (v - intr.cy) ** 2
    return torch.exp(-r2 / (2.0 * sigma * sigma)) * weight_mult


def _new_radius(z: torch.Tensor, nz: torch.Tensor, fx: float) -> torch.Tensor:
    r = 1.41421356 * z / fx
    return r / torch.clamp(torch.abs(nz), min=RADIUS_OBLIQUE_CLAMP)


def fuse_window(
    rows: torch.Tensor,  # [n_rows, 16] the block of map rows to update
    row_start: torch.Tensor,  # [] global index of rows[0]
    count: torch.Tensor,  # [] allocated map rows
    pred: splat.Prediction,  # ACTIVE-mode prediction at `pose` (global indices)
    vmap_c: torch.Tensor,
    nmap_c: torch.Tensor,
    rgb_c: torch.Tensor,
    pose: torch.Tensor,
    intr: CameraIntrinsics,
    time,
    sensor: int = 0,
    weight_mult=1.0,
    splat_k: int = 3,
    clean_depth: torch.Tensor | None = None,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    time_delta: int = 200,
    cluster_id=0.0,
    depth_gate_rel: float = 0.0,
    pack_sorted: bool = False,
):
    """Association + weighted update + inline clean + new-row packing for one
    block of map rows, without touching the full map.

    Returns ``(blk, packed, rank, n_want, matched, culled)``: the updated
    block, the [HW,16] candidate new rows, each row's insertion rank (-1 =
    not new; scanline order, or new-rows-first with `pack_sorted`), how many
    are real, and the matched / culled counts (0-dim tensors)."""
    dev = rows.device
    H, W, _ = vmap_c.shape
    HW = H * W
    t_now = scalar(time, torch.float32, dev)
    n_rows = rows.shape[0]

    z_f = vmap_c[..., 2]
    valid_f = (z_f > 0) & (torch.linalg.norm(nmap_c, dim=-1) > 0.5)
    gate = torch.clamp(depth_gate_rel * z_f, min=DEPTH_GATE)
    depth_ok = torch.abs(pred.depth - z_f) < gate
    norm_ok = torch.sum(pred.nmap * nmap_c, dim=-1) > NORMAL_DOT_GATE
    matched = valid_f & (pred.index >= 0) & depth_ok & norm_ok

    # --- per-pixel contribution payload ------------------------------------
    x_pix, y_pix = warp.pixel_grid(H, W, dev)
    conf_px = sample_confidence(x_pix, y_pix, intr, weight_mult)
    a = conf_px * matched
    p_w = se3.transform_points(pose, vmap_c)
    n_w = se3.rotate_vectors(pose, nmap_c)
    r_new = _new_radius(z_f, nmap_c[..., 2], intr.fx)
    a3 = a[..., None]
    rgb_f = rgb_c.to(torch.float32)
    payload = torch.cat(
        [
            torch.where(matched, pred.index, -1).to(torch.float32)[..., None],
            a3, a3 * p_w, a3 * n_w, a3 * rgb_f, (a * r_new)[..., None],
        ],
        dim=-1,
    )  # [H, W, 12]

    # --- pull pass: each surfel gathers the contributions addressed to it --
    idx = row_start + torch.arange(n_rows, device=dev)  # global row ids
    alive = (rows[:, sm.CONF] > 0) & (idx < count)
    Tinv = se3.se3_inverse(pose)
    p_s = se3.transform_points(Tinv, rows[:, sm.POS])
    z_s = p_s[:, 2]
    zsafe = torch.clamp(z_s, min=1e-6)
    u_s = p_s[:, 0] / zsafe * intr.fx + intr.cx
    v_s = p_s[:, 1] / zsafe * intr.fy + intr.cy
    ui = torch.clamp(torch.round(u_s), 0, W - 1).long()
    vi = torch.clamp(torch.round(v_s), 0, H - 1).long()
    in_view = alive & (z_s > 0.05) & (u_s >= 0) & (u_s <= W - 1) & (v_s >= 0) & (v_s <= H - 1)

    # sum each cell's 3x3 payload neighbourhood addressed to the cell's RAW
    # z-buffer winner (every surfel in `pred.index` won its own centre cell)
    win_f = pred.cell.to(torch.float32)
    acc = torch.zeros((H, W, 12), dtype=torch.float32, device=dev)
    half = splat_k // 2
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            t = warp.shift(payload, dy, dx)
            hit = (t[..., 0] == win_f) & (win_f >= 0)
            acc = acc + torch.where(hit[..., None], t, 0.0)
    obs_depth = clean_depth if clean_depth is not None else torch.zeros_like(z_f)
    gtab = torch.cat([win_f[..., None], acc[..., 1:12], obs_depth[..., None]], dim=-1)
    g = gtab.reshape(HW, 13)[vi * W + ui]  # the ONE per-surfel gather
    mine = in_view & (g[:, 0] == idx.to(torch.float32))
    sum_pay = torch.where(mine[:, None], g[:, 1:12], 0.0)

    sum_a = sum_pay[:, 0]
    touched = sum_a > 0
    inv_a = torch.clamp(sum_a, min=1e-12)
    mean_p = sum_pay[:, 1:4] / inv_a[:, None]
    mean_n = sum_pay[:, 4:7] / inv_a[:, None]
    mean_c = sum_pay[:, 7:10] / inv_a[:, None]
    mean_r = sum_pay[:, 10] / inv_a

    conf_old = rows[:, sm.CONF]
    r_old = rows[:, sm.RADIUS]
    geo_ok = touched & (mean_r < RADIUS_FUSE_FACTOR * r_old)
    blend = torch.where(geo_ok, sum_a / torch.clamp(conf_old + sum_a, min=1e-12), 0.0)[:, None]
    new_pos = rows[:, sm.POS] * (1 - blend) + mean_p * blend
    new_col = rows[:, sm.COLOR] * (1 - blend) + mean_c * blend
    nrm_mix = rows[:, sm.NORMAL] * (1 - blend) + mean_n * blend
    nrm_mix = nrm_mix / torch.clamp(torch.linalg.norm(nrm_mix, dim=-1, keepdim=True), min=1e-9)
    new_rad = rows[:, sm.RADIUS] * (1 - blend[:, 0]) + mean_r * blend[:, 0]

    upd = torch.cat(
        [
            new_pos, (conf_old + sum_a)[:, None], new_col, new_rad[:, None], nrm_mix,
            rows[:, sm.INIT_TIME][:, None], rows[:, sm.LAST_SEEN], rows[:, 15:16],
        ],
        dim=-1,
    )
    seen_col = 12 + sensor
    upd[:, seen_col] = t_now
    blk = torch.where(touched[:, None], upd, rows)

    # --- inline clean (reference copy_unstable outlier cull) ---------------
    if clean_depth is not None:
        d_obs = g[:, 12]
        fs_margin = torch.clamp(2.0 * depth_gate_rel * d_obs, min=FREE_SPACE_MARGIN)
        free_space = in_view & (d_obs > 0) & (z_s < d_obs - fs_margin)
        new_conf = blk[:, sm.CONF]
        age = t_now - sm.last_seen_any(blk)
        # stale-unstable culling only within the active epoch
        stale = alive & (new_conf < conf_threshold) & (age > unstable_ttl) & (age <= time_delta)
        kill = alive & (stale | free_space)
        blk[:, sm.CONF] = torch.where(kill, 0.0, new_conf)
        culled = kill.sum()
    else:
        culled = torch.zeros((), dtype=torch.int64, device=dev)

    # --- pack unmatched pixels as candidate new surfels ---------------------
    is_new = (valid_f & ~matched).reshape(HW)
    new_rows = torch.zeros((HW, 16), dtype=torch.float32, device=dev)
    new_rows[:, sm.POS] = p_w.reshape(HW, 3)
    new_rows[:, sm.CONF] = torch.clamp(conf_px.reshape(HW), min=1e-3)
    new_rows[:, sm.COLOR] = rgb_f.reshape(HW, 3)
    new_rows[:, sm.RADIUS] = r_new.reshape(HW)
    new_rows[:, sm.NORMAL] = n_w.reshape(HW, 3)
    new_rows[:, sm.INIT_TIME] = t_now
    new_rows[:, seen_col] = t_now
    new_rows[:, sm.CLUSTER] = scalar(cluster_id, torch.float32, dev)

    n_want = is_new.sum()
    if pack_sorted:
        order = torch.argsort((~is_new).to(torch.uint8), stable=True)  # new pixels first
        packed = new_rows[order]
        i = torch.arange(HW, device=dev)
        rank = torch.where(i < n_want, i, -1)
    else:
        packed = new_rows
        rank = torch.where(is_new, torch.cumsum(is_new, 0) - 1, -1)
    return blk, packed, rank, n_want, matched.sum(), culled


def place_updates(
    data: torch.Tensor,  # [N+1, 16] full map tensor, updated IN PLACE
    count: torch.Tensor,  # [] allocated rows
    blk: torch.Tensor,  # [n_rows, 16] updated block from fuse_window
    row_start: torch.Tensor,  # [] where blk goes
    packed: torch.Tensor,  # [S, 16] candidate new rows
    n_want: torch.Tensor,  # [] how many packed rows are real
    rank: torch.Tensor,  # [S] insertion rank per row (-1 = not new)
):
    """Write a fused block and append the frame's new rows at
    ``count + rank`` (the reference's contiguous append), keeping one row of
    headroom; rows past it are dropped and counted.

    Writes into `data` in place (the map is the largest tensor of the step,
    and the caller owns it); the dump row N receives the masked writes and
    is zeroed again, as the reference's gather placement leaves it.
    Returns ``(data, new_count, n_new, dropped)``."""
    N = data.shape[0] - 1
    data.index_copy_(0, row_start + torch.arange(blk.shape[0], device=data.device), blk)
    room = N - count
    n_new = torch.minimum(n_want, torch.clamp(room - 1, min=0))
    dest = torch.where((rank >= 0) & (rank < n_new), count + rank, N)
    data.index_copy_(0, dest, packed)
    data[N].fill_(0.0)
    new_count = torch.minimum(count + n_new, torch.full_like(count, N))
    return data, new_count, n_new, n_want - n_new


def _block(m: sm.SurfelMap, window: int):
    """(start, rows) of the rows a windowed pass touches: the active tail
    block when 0 < `window` < capacity, else every row but the dump row."""
    N = m.capacity
    if 0 < window < N:
        start = splat.active_window_start(m.count, N, window)
        return start, splat.window_rows(m.data, start, window)
    return torch.zeros((), dtype=torch.int64, device=m.data.device), m.data[:-1]


def fuse(
    m: sm.SurfelMap,
    vmap_c: torch.Tensor,  # [H,W,3] current frame camera-space vertices
    nmap_c: torch.Tensor,  # [H,W,3]
    rgb_c: torch.Tensor,  # [H,W,3] 0..255
    pose: torch.Tensor,  # [4,4] camera-to-world
    intr: CameraIntrinsics,
    time,
    sensor: int = 0,
    weight_mult=1.0,
    time_delta: int = 200,
    splat_k: int = 3,
    window: int = 0,
    packed_zbuffer: bool = True,
    cluster_id=0.0,
) -> Tuple[sm.SurfelMap, FuseStats]:
    """Fuse one RGB-D frame into the map at `pose`: the ACTIVE-mode
    association render, then `fuse_with_pred`.  `m.data` is updated in
    place (the reference donates it)."""
    pred = splat.render(
        m.data, m.count, pose, intr, vmap_c.shape[1], vmap_c.shape[0],
        scalar(time, torch.float32, m.data.device), time_delta=time_delta,
        mode=splat.MODE_ACTIVE, splat_k=splat_k, window=window,
        packed_zbuffer=packed_zbuffer,
    )
    return fuse_with_pred(
        m, pred, vmap_c, nmap_c, rgb_c, pose, intr, time, sensor=sensor,
        weight_mult=weight_mult, splat_k=splat_k, window=window, cluster_id=cluster_id,
    )


def fuse_with_pred(
    m: sm.SurfelMap,
    pred: splat.Prediction,  # ACTIVE-mode prediction at `pose` (global indices)
    vmap_c: torch.Tensor,
    nmap_c: torch.Tensor,
    rgb_c: torch.Tensor,
    pose: torch.Tensor,
    intr: CameraIntrinsics,
    time,
    sensor: int = 0,
    weight_mult=1.0,
    splat_k: int = 3,
    window: int = 0,
    clean_depth: torch.Tensor | None = None,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    time_delta: int = 200,
    cluster_id=0.0,
) -> Tuple[sm.SurfelMap, FuseStats]:
    """Fusion given an already-rendered association prediction: the window
    block, `fuse_window`, then `place_updates` (which writes `m.data` in
    place).  With `clean_depth` the outlier cull runs inline."""
    start, rows = _block(m, window)
    blk, packed, rank, n_want, matched, culled = fuse_window(
        rows, start, m.count, pred, vmap_c, nmap_c, rgb_c, pose, intr, time,
        sensor=sensor, weight_mult=weight_mult, splat_k=splat_k, clean_depth=clean_depth,
        conf_threshold=conf_threshold, unstable_ttl=unstable_ttl, time_delta=time_delta,
        cluster_id=cluster_id,
    )
    data, count, added, dropped = place_updates(
        m.data, m.count, blk, start, packed, n_want, rank
    )
    return sm.SurfelMap(data=data, count=count), FuseStats(matched, added, culled, dropped)


def clean(
    m: sm.SurfelMap,
    depth_frame: torch.Tensor,  # [H,W] metric depth of the current frame
    pose: torch.Tensor,
    intr: CameraIntrinsics,
    time,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    window: int = 0,
    time_delta: int = 200,
) -> Tuple[sm.SurfelMap, torch.Tensor]:
    """Cull bad surfels (reference `copy_unstable.vert` outlier logic):
    unstable surfels not refreshed within `unstable_ttl` ticks (inside the
    active epoch), and free-space violators that project well in front of
    the observed depth.  Culled rows get conf 0 in `m.data`, in place, and
    are reclaimed by `surfel_map.compact`.  Returns (map, culled count)."""
    H, W = depth_frame.shape
    dev = m.data.device
    t_now = scalar(time, torch.float32, dev)
    start, rows = _block(m, window)
    idx = start + torch.arange(rows.shape[0], device=dev)
    alive = (rows[:, sm.CONF] > 0) & (idx < m.count)

    p_c = se3.transform_points(se3.se3_inverse(pose), rows[:, sm.POS])
    z = p_c[:, 2]
    zsafe = torch.clamp(z, min=1e-6)
    u = p_c[:, 0] / zsafe * intr.fx + intr.cx
    v = p_c[:, 1] / zsafe * intr.fy + intr.cy
    ui = torch.clamp(torch.round(u), 0, W - 1).long()
    vi = torch.clamp(torch.round(v), 0, H - 1).long()
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0.05)
    d_obs = depth_frame[vi, ui]
    free_space = inb & (d_obs > 0) & (z < d_obs - FREE_SPACE_MARGIN)

    age = t_now - sm.last_seen_any(rows)
    stale = (rows[:, sm.CONF] < conf_threshold) & (age > unstable_ttl) & (age <= time_delta)
    kill = alive & (stale | free_space)
    m.data[idx, sm.CONF] = torch.where(kill, 0.0, rows[:, sm.CONF])
    return sm.SurfelMap(data=m.data, count=m.count), kill.sum()
