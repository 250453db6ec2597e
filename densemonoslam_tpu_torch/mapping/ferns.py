"""Random-fern keyframe encoding for place recognition and relocalisation
(port of `densemonoslam_tpu.mapping.ferns`).

n=500 ferns at random pixels of the 8x-downsampled frame each emit a 4-bit
code by thresholding R, G, B and depth; a frame is stored as a fern keyframe
when its minimum dissimilarity to the database exceeds `FERN_THRESH`, and
retrieval returns the most similar stored frame.  The query is compared with
the WHOLE database at once ([K, 500] codes against [500]).

The database is a set of fixed-capacity tensors that `add_frame` updates in
place; each stored frame keeps its downsampled intensity and depth for the
photometric check.  `make_coder` draws its tests from the same seeded numpy
generator as the reference, so both packages produce the same codes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch.ops import warp
from densemonoslam_tpu_torch.utils.tensors import scalar

NUM_FERNS = 500
FERN_THRESH = 0.3095
PHOTO_THRESH = 115.0


class FernCoder(NamedTuple):
    """Random fern test positions and thresholds (fixed at startup)."""

    ux: torch.Tensor  # [F] int64 x pixel in the downsampled frame
    vy: torch.Tensor  # [F] int64 y pixel
    thresh_rgb: torch.Tensor  # [F, 3] f32 0..255
    thresh_d: torch.Tensor  # [F] f32 metres


class FernDB(NamedTuple):
    """Fixed-capacity keyframe database."""

    codes: torch.Tensor  # [K, F] int32 4-bit codes
    poses: torch.Tensor  # [K, 4, 4]
    intensity: torch.Tensor  # [K, h, w] stored downsampled intensity
    depth: torch.Tensor  # [K, h, w] stored downsampled metric depth
    times: torch.Tensor  # [K] tick of insertion (-1 = empty)
    count: torch.Tensor  # [] int64


def make_coder(
    width: int, height: int, depth_max: float, seed: int = 0,
    num_ferns: int = NUM_FERNS, device: torch.device | str = "cuda",
) -> FernCoder:
    """Random fern tests over the downsampled resolution, drawn from
    `np.random.default_rng(seed)` in the reference's order."""
    rng = np.random.default_rng(seed)
    ux = rng.integers(0, width, num_ferns)
    vy = rng.integers(0, height, num_ferns)
    thresh_rgb = rng.uniform(0, 255, (num_ferns, 3)).astype(np.float32)
    thresh_d = rng.uniform(0.1, depth_max, num_ferns).astype(np.float32)
    return FernCoder(
        ux=torch.from_numpy(ux.astype(np.int64)).to(device),
        vy=torch.from_numpy(vy.astype(np.int64)).to(device),
        thresh_rgb=torch.from_numpy(thresh_rgb).to(device),
        thresh_d=torch.from_numpy(thresh_d).to(device),
    )


def empty_db(
    capacity: int, height: int, width: int, num_ferns: int = NUM_FERNS,
    device: torch.device | str = "cuda",
) -> FernDB:
    f32 = dict(dtype=torch.float32, device=device)
    return FernDB(
        codes=torch.zeros((capacity, num_ferns), dtype=torch.int32, device=device),
        poses=torch.eye(4, **f32).expand(capacity, 4, 4).clone(),
        intensity=torch.zeros((capacity, height, width), **f32),
        depth=torch.zeros((capacity, height, width), **f32),
        times=torch.full((capacity,), -1.0, **f32),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def encode(coder: FernCoder, rgb_small: torch.Tensor, depth_small: torch.Tensor) -> torch.Tensor:
    """Downsampled frame -> [F] int32 4-bit codes: bit k is set when channel
    k (R, G, B, depth) exceeds its threshold."""
    px_rgb = rgb_small[coder.vy, coder.ux].to(torch.float32)  # [F, 3]
    px_d = depth_small[coder.vy, coder.ux]
    bits = torch.cat([px_rgb > coder.thresh_rgb, (px_d > coder.thresh_d)[:, None]], dim=-1)
    weights = torch.pow(2, torch.arange(4, device=bits.device))  # 1, 2, 4, 8
    return (bits.to(torch.int64) * weights).sum(dim=-1).to(torch.int32)


def dissimilarity(db: FernDB, code: torch.Tensor) -> torch.Tensor:
    """[K] fraction of ferns whose codes differ (1.0 for empty slots).  The
    exact count is scaled by f32(1/F), the rounding of the reference's mean."""
    F = db.codes.shape[1]
    n_diff = (db.codes != code[None, :]).sum(dim=-1).to(torch.float32)
    diff = n_diff * torch.full((), 1.0 / F, dtype=torch.float32, device=code.device)
    k = torch.arange(db.codes.shape[0], device=code.device)
    return torch.where(k < db.count, diff, 1.0)


def best_match(
    db: FernDB, code: torch.Tensor, exclude_after: torch.Tensor | float = float("inf")
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best index, its dissimilarity), both 0-dim device tensors; frames
    inserted at or after `exclude_after` ticks are ignored.  The first of
    equal minima wins, as `jnp.argmin`."""
    d = dissimilarity(db, code)
    d = torch.where(db.times < exclude_after, d, 1.0)
    i = torch.argmin(d)
    # gather: indexing with a 0-dim tensor would read it on the host
    return i, d.gather(0, i.reshape(1))[0]


def _most_redundant(db: FernDB) -> torch.Tensor:
    """Slot of the keyframe with the smallest dissimilarity to its nearest
    other keyframe.  Agreements eq[i, j] = #ferns on which keyframes i and j
    agree, as one product of one-hot codes: 0/1 products summed in f32 are
    exact integers (<= F << 2^24), the counts the reference's bf16 one-hot
    product gives."""
    K, F = db.codes.shape
    oh = torch.nn.functional.one_hot(db.codes.long(), 16).to(torch.float32).reshape(K, -1)
    eq = oh @ oh.T
    dis = 1.0 - eq / float(F)
    i = torch.arange(K, device=oh.device)
    live = i < db.count
    # self-pairs and empty slots never count as neighbours
    pair = live[:, None] & live[None, :] & (i[:, None] != i[None, :])
    dis = torch.where(pair, dis, float("inf"))
    nn = torch.where(live, dis.min(dim=1).values, float("inf"))
    return torch.argmin(nn)


def add_frame(
    db: FernDB,
    code: torch.Tensor,
    pose: torch.Tensor,
    intensity_small: torch.Tensor,
    depth_small: torch.Tensor,
    time: torch.Tensor | float,
    min_dissim: torch.Tensor,
    thresh: float = FERN_THRESH,
    evict: bool = False,
) -> Tuple[FernDB, torch.Tensor]:
    """Insert the frame if it is novel enough (min dissimilarity > `thresh`,
    or the DB is empty).  Returns (db, added) with `added` a device bool.
    The DB's tensors are written in place; the returned DB carries the new
    count.

    With `evict=True` a FULL database still accepts novel frames by
    overwriting its most redundant entry (`_most_redundant`); that search
    costs one host read of whether it is needed."""
    K = db.codes.shape[0]
    dev = code.device
    novel = (min_dissim > thresh) | (db.count == 0)
    full = db.count >= K
    add = novel & ((db.count < K) | (full & evict))
    slot = torch.where(add, db.count, K - 1)
    if evict and bool(full & novel):
        slot = _most_redundant(db)
    slot = slot.reshape(1)
    time_t = scalar(time, torch.float32, dev)
    for arr, val in (
        (db.codes, code), (db.poses, pose), (db.intensity, intensity_small),
        (db.depth, depth_small), (db.times, time_t),
    ):
        old = arr.index_select(0, slot)
        arr.index_copy_(0, slot, torch.where(add, val.to(arr.dtype)[None], old))
    count = torch.clamp(db.count + add.to(torch.int64), max=K)
    return db._replace(count=count), add


def photometric_check(
    stored_intensity: torch.Tensor,
    query_intensity: torch.Tensor,
    stored_depth: torch.Tensor,
    query_depth: torch.Tensor,
) -> torch.Tensor:
    """Mean absolute intensity difference over mutually valid pixels
    (compare against `PHOTO_THRESH` outside)."""
    valid = (stored_depth > 0) & (query_depth > 0)
    diff = torch.abs(stored_intensity - query_intensity) * valid
    return diff.sum() / torch.clamp(valid.sum().to(torch.float32), min=1.0)


def downsample_for_ferns(img: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Decimation for fern encoding (2^fern_pyr_level, 8x by default)."""
    return warp.decimate(img, factor)


def grow_db(db: FernDB) -> FernDB:
    """Double the DB capacity (the reference's keyframe vector is unbounded;
    the fixed-capacity tensors grow geometrically)."""
    K, F = db.codes.shape
    h, w = db.intensity.shape[1:]
    fresh = empty_db(K, h, w, num_ferns=F, device=db.codes.device)
    return FernDB(
        codes=torch.cat([db.codes, fresh.codes]),
        poses=torch.cat([db.poses, fresh.poses]),
        intensity=torch.cat([db.intensity, fresh.intensity]),
        depth=torch.cat([db.depth, fresh.depth]),
        times=torch.cat([db.times, fresh.times]),
        count=db.count,
    )
