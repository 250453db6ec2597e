"""Fixed-capacity surfel map: one packed ``f32[N+1, 16]`` tensor plus an
allocation counter (port of `densemonoslam_tpu.mapping.surfel_map`).

Row N is a write-dump slot for masked writes.  Column layout (f32):
    0:3   position (world frame)
    3     confidence (0 = free slot / culled)
    4:7   rgb color (0..255)
    7     radius (metres)
    8:11  normal (unit, world frame)
    11    init_time (tick of creation)
    12:15 last-seen tick per sensor (MAX_SENSORS = 3)
    15    cluster id

`count` is a 0-dim int64 tensor on the map's device (the reference keeps
int32; the port uses torch's index type).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

POS = slice(0, 3)
CONF = 3
COLOR = slice(4, 7)
RADIUS = 7
NORMAL = slice(8, 11)
INIT_TIME = 11
LAST_SEEN = slice(12, 15)
CLUSTER = 15
COLS = 16
MAX_SENSORS = 3


@dataclasses.dataclass(frozen=True)
class SurfelMap:
    """The map state.  `data` has capacity+1 rows; `count` is the number of
    allocated slots (culled surfels keep conf == 0 until compaction)."""

    data: torch.Tensor  # [N+1, 16] f32
    count: torch.Tensor  # [] int64

    @property
    def capacity(self) -> int:
        return self.data.shape[0] - 1

    # --- column views (slices, no copy) -----------------------------------
    @property
    def positions(self) -> torch.Tensor:
        return self.data[:-1, POS]

    @property
    def confidences(self) -> torch.Tensor:
        return self.data[:-1, CONF]

    @property
    def colors(self) -> torch.Tensor:
        return self.data[:-1, COLOR]

    @property
    def radii(self) -> torch.Tensor:
        return self.data[:-1, RADIUS]

    @property
    def normals(self) -> torch.Tensor:
        return self.data[:-1, NORMAL]

    @property
    def init_times(self) -> torch.Tensor:
        return self.data[:-1, INIT_TIME]

    @property
    def last_seen(self) -> torch.Tensor:
        return self.data[:-1, LAST_SEEN]

    @property
    def alive(self) -> torch.Tensor:
        """Boolean [N]: slot holds a live surfel."""
        idx = torch.arange(self.capacity, device=self.data.device)
        return (self.data[:-1, CONF] > 0) & (idx < self.count)

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def empty_map(capacity: int, device: torch.device | str = "cuda") -> SurfelMap:
    """A map of `capacity` free rows on `device` (the card unless the caller
    says otherwise)."""
    return SurfelMap(
        data=torch.zeros((capacity + 1, COLS), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def last_seen_any(data: torch.Tensor) -> torch.Tensor:
    """Latest tick any sensor saw each row of `data`."""
    return torch.amax(data[:, LAST_SEEN], dim=-1)


def append_surfels(m: SurfelMap, attrs: torch.Tensor, valid: torch.Tensor) -> SurfelMap:
    """Append the `valid` rows of `attrs` [K, 16] after `count`, in order;
    invalid rows and rows past capacity land in the dump slot (row N).
    Writes `m.data` in place; returns the map with its new count."""
    cap = m.capacity
    dest = m.count + torch.cumsum(valid.to(torch.int64), 0) - 1
    dest = torch.where(valid & (dest < cap), dest, cap)
    m.data[dest] = attrs
    count = torch.clamp(m.count + valid.sum(), max=cap)
    return SurfelMap(data=m.data, count=count)


def compact(m: SurfelMap, time: float, time_delta: int, max_active: int = 0) -> SurfelMap:
    """Move live surfels to the front with a STABLE sort (temporal order is
    kept), partitioned [inactive..., active...] (active = last seen within
    `time_delta` of `time`) so the hot ACTIVE passes can stream the tail
    block (`splat.active_window_start`); with `max_active` > 0, the oldest
    active overflow is demoted to inactive.

    Returns a new map; `m.data` is left untouched."""
    alive = m.alive
    t_now = torch.full((), time, dtype=torch.float32, device=m.data.device)
    active = alive & (t_now - last_seen_any(m.data[:-1]) < time_delta)
    key = torch.where(active, 1, torch.where(alive, 0, 2))
    order = torch.argsort(key, stable=True)
    data = m.data.clone()
    data[:-1] = m.data[:-1][order]
    count = alive.sum()
    # zero the confidences past the new count so stale rows cannot resurface
    idx = torch.arange(m.capacity, device=m.data.device)
    data[:-1, CONF] = torch.where(idx < count, data[:-1, CONF], 0.0)
    if max_active > 0:
        # post-sort the layout is [inactive..., active...]: the overflow is
        # the first (n_active - max_active) rows of the active tail
        n_active = (key == 1).sum()
        demote = (idx >= count - n_active) & (idx < count - max_active)
        t_inact = t_now - float(time_delta)
        ls = data[:-1, LAST_SEEN]
        data[:-1, LAST_SEEN] = torch.where(demote[:, None], torch.minimum(ls, t_inact), ls)
    return SurfelMap(data=data, count=count)


class MapSnapshot(NamedTuple):
    """Host-side export of the live surfels (for PLY/eval)."""

    positions: np.ndarray
    normals: np.ndarray
    colors: np.ndarray
    radii: np.ndarray
    confidences: np.ndarray
    init_times: np.ndarray
    clusters: np.ndarray


def snapshot(m: SurfelMap, conf_threshold: float = 0.0) -> MapSnapshot:
    """Copy live (optionally stable-only) surfels to host arrays."""
    keep = m.alive
    if conf_threshold > 0:
        keep = keep & (m.data[:-1, CONF] > conf_threshold)
    data = m.data[:-1][keep].cpu().numpy()
    return MapSnapshot(
        positions=data[:, POS],
        normals=data[:, NORMAL],
        colors=data[:, COLOR],
        radii=data[:, RADIUS],
        confidences=data[:, CONF],
        init_times=data[:, INIT_TIME],
        clusters=data[:, CLUSTER].astype(int),
    )
