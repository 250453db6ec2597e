"""Sparse ORB-style feature tracker (port of `densemonoslam_tpu.tracking.
sparse`): FAST corners + oriented BRIEF over a scale pyramid, Hamming
matching, motion-only pose optimisation, keyframe loop detection and
pose-graph optimisation.

- **FAST-9/16** is dense: the 16 circle taps are slices of one zero-padded
  image, the >= 9-contiguous arc test is a window sum over the ring, and
  non-max suppression is a 3x3 max pool.  Corners are detected at the low
  threshold and ranked so that corners passing the high one come first (the
  reference's two-threshold policy as one ranking, with no host retry).
- **Scale pyramid**: `octaves` levels at factor 1.2, feature quotas
  proportional to each level's area; intensity is resized with antialiasing
  (as `jax.image.resize` does on a downscale), depth by nearest sample.
- **Orientation** is the intensity centroid of a radius-7 disc, and the
  steered **BRIEF-256** descriptor samples 256 rotated test pairs; both
  gather at the selected corners only.
- **Matching** is mutual-best Hamming with a ratio test.  Hamming distances
  come from one matrix product of the descriptors' unpacked bits, exact in
  f32 (every partial sum is an integer below 2^24).
- **Pose** is motion-only Gauss-Newton on 3D->2D reprojection errors with a
  Huber weight; **loop retrieval** is one matvec against per-keyframe
  descriptor-bit summaries; **PGO** and the sliding-window **local BA** are
  `parallel.ba`.

Top-k selections reproduce `jax.lax.top_k`'s tie rule (the lower index
first) with a stable descending sort.  Descriptors are [K, 8] int64 holding
the reference's uint32 words bit for bit.

The per-frame path (`SparseTracker.track`) queues device work only and
never reads the device; keyframe insertion and loop decisions happen in
`flush()` every `flush_interval` frames, as a pipeline lagged by one
interval, so each batched fetch reads values that have long executed.

Its stages are `utils.timer` spans: `sparse.detect` and `sparse.match_pose`
each frame; `sparse.flush` with one child per stage it runs
(`sparse.keyframes`, `sparse.retrieve`, `sparse.verify`, `sparse.pgo`,
`sparse.ba_fetch`, `sparse.ba_apply`); and each read of the device a
`host.read` inside them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.parallel import ba
from densemonoslam_tpu_torch.utils import se3, timer

FAST_THRESHOLD = 20.0  # reference yaml iniThFAST
FAST_THRESHOLD_MIN = 7.0  # reference yaml minThFAST (fallback)
FAST_ARC = 9
MAX_KEYPOINTS = 512
DESC_WORDS = 8  # 256 bits as 8 x 32-bit words
MATCH_MAX_DIST = 64  # Hamming acceptance
MATCH_RATIO = 0.9  # best/second-best gate
SCALE_FACTOR = 1.2  # reference yaml ORBextractor.scaleFactor
OCTAVES = 4
MARGIN = 16  # border guard: circle + descriptor support
MOMENT_RADIUS = 7

# Bresenham circle of radius 3 (the 16 FAST taps, standard order), (dy, dx)
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int64,
)

# the orientation disc's taps (dy, dx)
_DISC = np.array(
    [
        (dy, dx)
        for dy in range(-MOMENT_RADIUS, MOMENT_RADIUS + 1)
        for dx in range(-MOMENT_RADIUS, MOMENT_RADIUS + 1)
        if dx * dx + dy * dy <= MOMENT_RADIUS * MOMENT_RADIUS
    ],
    dtype=np.int64,
)


def _brief_pattern(seed: int = 7, n: int = 256, radius: int = 13) -> np.ndarray:
    """Random BRIEF test pairs ~N(0, (radius/2)^2), clipped (the classic
    BRIEF-256 generator)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, radius / 2.0, (n, 2, 2)), -radius, radius)
    return pts.astype(np.float32)  # [256, 2 (pair), 2 (y,x)]


_PATTERN = _brief_pattern()
_CONSTS: Dict[torch.device, dict] = {}


def _consts(device: torch.device) -> dict:
    """The detector's constant tables on `device`, uploaded once per device
    (an upload per call would synchronise the stream)."""
    device = torch.device(device)
    if device not in _CONSTS:
        _CONSTS[device] = dict(
            pattern=torch.from_numpy(_PATTERN).to(device),
            disc_dy=torch.from_numpy(_DISC[:, 0]).to(device),
            disc_dx=torch.from_numpy(_DISC[:, 1]).to(device),
            disc_wx=torch.from_numpy(_DISC[:, 1].astype(np.float32)).to(device),
            disc_wy=torch.from_numpy(_DISC[:, 0].astype(np.float32)).to(device),
            bit_shifts=torch.arange(32, dtype=torch.int64, device=device),
        )
    return _CONSTS[device]


class Keypoints(NamedTuple):
    uv: torch.Tensor  # [K, 2] float pixel coords (x, y) at level-0 scale
    score: torch.Tensor  # [K] FAST score
    angle: torch.Tensor  # [K] orientation (radians)
    desc: torch.Tensor  # [K, 8] int64 holding uint32 BRIEF-256 words
    depth: torch.Tensor  # [K] metric depth at the corner (0 = unknown)
    valid: torch.Tensor  # [K] bool


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of a 1-D tensor, the lower
    index first on ties (`jax.lax.top_k`'s rule)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _has_arc(bits: torch.Tensor) -> torch.Tensor:
    """bits [..., 16, H, W] bool on the circle -> [..., H, W]: some run of
    >= FAST_ARC consecutive set bits on the 16-ring."""
    ring = torch.cat([bits, bits[..., : FAST_ARC - 1, :, :]], dim=-3).to(torch.int32)
    c = F.pad(torch.cumsum(ring, dim=-3), (0, 0, 0, 0, 1, 0))
    window = c[..., FAST_ARC : FAST_ARC + 16, :, :] - c[..., :16, :, :]
    return (window == FAST_ARC).any(dim=-3)


def detect_and_describe(
    intensity: torch.Tensor,  # [H, W] f32 0..255
    depth: torch.Tensor,  # [H, W] metric (0 invalid)
    threshold: float = FAST_THRESHOLD_MIN,
    high_threshold: float = FAST_THRESHOLD,
    max_kp: int = MAX_KEYPOINTS,
) -> Keypoints:
    """Dense FAST-9 + orientation + steered BRIEF for one frame.

    Corners are detected at `threshold`; the top-K selection prefers corners
    that also pass `high_threshold`."""
    H, W = intensity.shape
    dev = intensity.device
    cst = _consts(dev)

    # --- FAST-9/16: the 16 taps as slices of one zero-padded image --------
    pad = F.pad(intensity, (3, 3, 3, 3))
    taps = torch.stack([pad[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dy, dx in _CIRCLE])
    diff = taps - intensity
    bits = torch.stack([diff > threshold, diff < -threshold,
                        diff > high_threshold, diff < -high_threshold])
    arcs = _has_arc(bits)  # [4, H, W]
    is_corner = arcs[0] | arcs[1]
    is_strong = arcs[2] | arcs[3]
    score_acc = diff.abs().sum(dim=0)
    score = torch.where(is_corner, score_acc, 0.0)
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    inb = (cols >= MARGIN) & (cols < W - MARGIN) & (rows >= MARGIN) & (rows < H - MARGIN)
    score = torch.where(inb, score, 0.0)
    # non-max suppression over 3x3 (scores are >= 0, so the pool's -inf
    # border acts as the reference's zero fill)
    neigh_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= neigh_max, score, 0.0)

    # --- top-K corners (strong-threshold corners rank first) ---------------
    rank_key = score + torch.where(is_strong & (score > 0), 1e6, 0.0)
    top_rank, top_idx = _top_k(rank_key.reshape(-1), max_kp)
    top_score = score.reshape(-1)[top_idx]
    iy, ix = top_idx // W, top_idx % W
    ky, kx = iy.to(torch.float32), ix.to(torch.float32)
    valid = top_rank > 0

    # --- orientation: intensity centroid of the disc at each corner --------
    R = MOMENT_RADIUS
    padm = F.pad(intensity, (R, R, R, R)).reshape(-1)
    Wp = W + 2 * R
    flat = (iy[None] + R + cst["disc_dy"][:, None]) * Wp + (ix[None] + R + cst["disc_dx"][:, None])
    patch = padm[flat]  # [taps, K]
    g10 = cst["disc_wx"] @ patch
    g01 = cst["disc_wy"] @ patch
    angle = torch.atan2(g01, g10)

    # --- steered BRIEF ------------------------------------------------------
    ca, sa = torch.cos(angle), torch.sin(angle)
    pat = cst["pattern"]
    py, px = pat[..., 0], pat[..., 1]  # [256, 2]
    rx = ca[:, None, None] * px[None] - sa[:, None, None] * py[None]
    ry = sa[:, None, None] * px[None] + ca[:, None, None] * py[None]
    sx = torch.clamp(torch.round(kx[:, None, None] + rx), 0, W - 1).to(torch.int64)
    sy = torch.clamp(torch.round(ky[:, None, None] + ry), 0, H - 1).to(torch.int64)
    samples = intensity.reshape(-1)[sy * W + sx]  # [K, 256, 2]
    bits = (samples[:, :, 0] < samples[:, :, 1]).to(torch.int64).reshape(max_kp, DESC_WORDS, 32)
    desc = torch.sum(bits << cst["bit_shifts"], dim=-1)

    kd = depth.reshape(-1)[top_idx]
    return Keypoints(
        uv=torch.stack([kx, ky], dim=-1),
        score=top_score,
        angle=angle,
        desc=desc,
        depth=torch.where(valid, kd, 0.0),
        valid=valid,
    )


def _octave_shapes(H: int, W: int, octaves: int, scale: float):
    return [
        (max(int(round(H / scale**o)), 48), max(int(round(W / scale**o)), 64))
        for o in range(octaves)
    ]


def _octave_quotas(octaves: int, scale: float, max_kp: int):
    """Per-octave feature budgets ~ image area (the reference distributes
    nfeatures over levels the same way)."""
    w = np.array([1.0 / (scale * scale) ** o for o in range(octaves)])
    q = np.maximum((w / w.sum() * max_kp).astype(int), 16)
    q[0] += max_kp - q.sum()  # exact total
    return [int(x) for x in q]


def detect_pyramid(
    intensity: torch.Tensor,
    depth: torch.Tensor,
    threshold: float = FAST_THRESHOLD_MIN,
    high_threshold: float = FAST_THRESHOLD,
    octaves: int = OCTAVES,
    scale: float = SCALE_FACTOR,
    max_kp: int = MAX_KEYPOINTS,
) -> Keypoints:
    """Multi-octave detection: each octave detects on a 1.2^o-downscaled
    image; keypoint coordinates are mapped back to level-0 pixels and the
    descriptors keep their octave's support."""
    H, W = intensity.shape
    parts = []
    for o, ((h, w), q) in enumerate(
        zip(_octave_shapes(H, W, octaves, scale), _octave_quotas(octaves, scale, max_kp))
    ):
        if o == 0:
            inten_o, depth_o = intensity, depth
        else:
            inten_o = F.interpolate(
                intensity[None, None], size=(h, w), mode="bilinear", align_corners=False,
                antialias=True,
            )[0, 0]
            # nearest for depth: interpolation across silhouettes invents geometry
            depth_o = F.interpolate(depth[None, None], size=(h, w), mode="nearest-exact")[0, 0]
        kp = detect_and_describe(inten_o, depth_o, threshold, high_threshold, max_kp=q)
        sx, sy = W / w, H / h
        parts.append(kp._replace(uv=torch.stack([kp.uv[:, 0] * sx, kp.uv[:, 1] * sy], dim=-1)))
    return Keypoints(*(torch.cat([getattr(p, f) for p in parts]) for f in Keypoints._fields))


def _desc_bits(desc: torch.Tensor) -> torch.Tensor:
    """[K, 8] words -> [K, 256] bits as f32 0/1 (bit b of word w at 32w+b)."""
    shifts = _consts(desc.device)["bit_shifts"]
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256).to(torch.float32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Ka, Kb] int32 Hamming distances between two descriptor sets:
    popcount(a ^ b) = |a| + |b| - 2 a.b over the bits, one exact f32 matrix
    product."""
    ba, bb = _desc_bits(a), _desc_bits(b)
    d = ba.sum(dim=1)[:, None] + bb.sum(dim=1)[None, :] - 2.0 * (ba @ bb.T)
    return d.to(torch.int32)


def match(a: Keypoints, b: Keypoints) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-best Hamming matching with ratio test.

    Returns (idx_b [K] int64: match in b for each a, -1 none; dist [K])."""
    big = 10**6
    dist = torch.where(a.valid[:, None] & b.valid[None, :], _hamming(a.desc, b.desc), big)
    ar = torch.arange(dist.shape[0], device=dist.device)
    best_b = torch.argmin(dist, dim=1)  # the first index on ties, as jnp.argmin
    d1 = dist.gather(1, best_b[:, None])[:, 0]
    d_wo = dist.scatter(1, best_b[:, None], big)
    d2 = d_wo.min(dim=1).values
    best_a_of_b = torch.argmin(dist, dim=0)
    mutual = best_a_of_b[best_b] == ar
    ok = (
        mutual
        & (d1 <= MATCH_MAX_DIST)
        & (d1.to(torch.float32) <= MATCH_RATIO * torch.clamp(d2, min=1).to(torch.float32))
    )
    return torch.where(ok, best_b, -1), d1


def motion_only_pose(
    kp_prev: Keypoints,
    kp_cur: Keypoints,
    matches: torch.Tensor,  # [K] index into kp_cur (or -1)
    intr: CameraIntrinsics,
    A_init: torch.Tensor,  # [4,4] cur-cam -> prev-cam initial guess
    iters: int = 10,
    huber_px: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the reprojection error of previous-frame 3D points
    (back-projected from kp_prev depth) into the current frame.  Solves for
    A (current camera -> previous camera).  Returns (A, inliers,
    mean_err_px), all on the device; no host reads."""
    dev = A_init.device
    m_safe = torch.clamp(matches, min=0)
    u_p, v_p = kp_prev.uv[:, 0], kp_prev.uv[:, 1]
    z_p = kp_prev.depth
    X = torch.stack(
        [(u_p - intr.cx) / intr.fx * z_p, (v_p - intr.cy) / intr.fy * z_p, z_p], dim=-1
    )
    uv_c = kp_cur.uv[m_safe]
    base_ok = (matches >= 0) & (z_p > 0.05) & kp_prev.valid
    eye6 = 1e-4 * torch.eye(6, dtype=torch.float32, device=dev)
    A = A_init
    inl = err_mean = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        Ainv = se3.se3_inverse(A)
        p = se3.transform_points(Ainv, X)
        z = torch.clamp(p[:, 2], min=1e-6)
        u = p[:, 0] / z * intr.fx + intr.cx
        v = p[:, 1] / z * intr.fy + intr.cy
        ru = u - uv_c[:, 0]
        rv = v - uv_c[:, 1]
        err = torch.sqrt(ru * ru + rv * rv)
        w_huber = torch.where(err > huber_px, huber_px / torch.clamp(err, min=1e-9), 1.0)
        ok = base_ok & (p[:, 2] > 0.05) & (err < 30.0)
        wgt = torch.sqrt(w_huber) * ok
        # d(residual)/d(xi) for the left update of A: p = Ainv exp(-xi) X
        zero = torch.zeros_like(z)
        Ju = torch.stack([intr.fx / z, zero, -intr.fx * p[:, 0] / (z * z)], dim=-1)
        Jv = torch.stack([zero, intr.fy / z, -intr.fy * p[:, 1] / (z * z)], dim=-1)
        Rinv = Ainv[:3, :3]

        def rows(Jpix, r):
            g = -(Jpix @ Rinv)  # dr/d(dp in prev frame)
            Jw = torch.linalg.cross(X, g)
            M = torch.cat([Jw, g, r[:, None], torch.ones_like(r)[:, None]], dim=-1)
            return M * wgt[:, None]

        M = torch.cat([rows(Ju, ru), rows(Jv, rv)], dim=0)
        G = M.T @ M
        JtJ, Jtr = G[:6, :6], G[:6, 6]
        xi = torch.linalg.solve_ex(JtJ + eye6, -Jtr)[0]
        n_ok = ok.to(torch.float32).sum()
        good = torch.all(torch.isfinite(xi)) & (n_ok > 6)
        A = torch.where(good, se3.se3_exp(xi) @ A, A)
        inl = n_ok
        err_mean = torch.sum(err * ok) / torch.clamp(n_ok, min=1.0)
    return A, inl, err_mean


def desc_summary(kp: Keypoints) -> torch.Tensor:
    """[256] mean descriptor bit over valid keypoints: the keyframe's
    retrieval signature (the DBoW bag-of-words role)."""
    bits = _desc_bits(kp.desc)
    v = kp.valid.to(torch.float32)[:, None]
    return torch.sum(bits * v, dim=0) / torch.clamp(v.sum(), min=1.0)


def retrieve(
    summaries: torch.Tensor,  # [Kcap, 256]
    n_kf: int,
    query: torch.Tensor,  # [256]
    max_idx: int,  # only keyframes with index < max_idx
    top_k: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k loop candidates by cosine similarity of bit summaries: one
    matvec regardless of the keyframe count."""
    q = query - 0.5
    s = summaries - 0.5
    num = s @ q
    den = torch.linalg.norm(s, dim=-1) * torch.clamp(torch.linalg.norm(q), min=1e-9)
    sim = num / torch.clamp(den, min=1e-9)
    idx = torch.arange(summaries.shape[0], device=summaries.device)
    sim = torch.where((idx < n_kf) & (idx < max_idx), sim, -2.0)
    best_sims, best_idx = _top_k(sim, top_k)
    return best_idx, best_sims


def _fetch(*tensors: torch.Tensor) -> list:
    """Read several device tensors in ONE transfer: flattened to f32,
    concatenated, copied once, split back (as numpy, in their shapes)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    with timer.span("host.read"):
        flat = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[o : o + n].reshape(tuple(t.shape)))
        o += n
    return out


def _upload(device: torch.device, *arrays: np.ndarray) -> list:
    """Copy several numpy arrays to `device` in ONE transfer (as f32, split
    back on the device; integer arrays must be exact in f32)."""
    flat = torch.from_numpy(
        np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays])
    ).to(device)
    out, o = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(flat[o : o + n].reshape(np.shape(a)))
        o += n
    return out


def edge_capacity(n_edges: int, n_shards: int = 1) -> int:
    """The pose graph's padded edge count: the power of two (>= 8) that
    holds `n_edges`, rounded up to a multiple of `n_shards`, which need
    not be a power of two (ROADMAP R3)."""
    cap = 8
    while cap < n_edges:
        cap *= 2
    return -(-cap // n_shards) * n_shards


class SparseTracker:
    """Host-side tracker state machine (the `ORB_SLAM3::System` role for
    the hybrid path): per-frame pose from motion-only GN against the previous
    frame, keyframe insertion by baseline, loop candidates by summary
    retrieval + geometric verification, pose-graph optimisation on closure,
    sliding-window local BA.

    Per-frame work is pure device dispatch; host decisions happen in
    `flush()` every `flush_interval` frames with one batched read.  Runs on
    the card unless `device` says otherwise.

    With `mesh` (a `parallel.mesh.Mesh`) local BA and PGO are split over
    its `cam` group (`ba.make_distributed_ba` / `make_distributed_pgo`):
    each solve is a collective, so every rank of the group drives its
    tracker with the same frames."""

    def __init__(
        self,
        intr: CameraIntrinsics,
        keyframe_min_disp: float = 0.08,
        loop_min_gap: int = 30,
        loop_min_votes: int = 60,
        octaves: int = OCTAVES,
        flush_interval: int = 4,
        run_pgo: bool = True,
        local_ba_window: int = 6,
        run_local_ba: bool = True,
        local_ba_min_baseline: float = 0.25,
        mesh=None,
        device: torch.device | str = "cuda",
    ):
        self.intr = intr
        self.mesh = mesh
        self._dist_ba = self._dist_pgo = None
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SparseTracker runs on the card by default and no CUDA device is "
                'available: pass device="cpu" to run on the CPU'
            )
        self._pose = torch.eye(4, dtype=torch.float32, device=self.device)  # camera-to-world
        self.keyframes: list = []  # (Keypoints, pose_np [4,4], tick)
        self.tick = 0
        self.kf_min_disp = keyframe_min_disp
        self.loop_min_gap = loop_min_gap
        self.loop_min_votes = loop_min_votes
        self.octaves = octaves
        self.flush_interval = flush_interval
        self.run_pgo = run_pgo
        self.local_ba_window = local_ba_window
        self.run_local_ba = run_local_ba
        self.local_ba_min_baseline = local_ba_min_baseline
        self.last_loop: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_loop_tick: int = -1  # tick of the loop pair's keyframe
        # (kf_ticks, kf_poses_before, kf_poses_after) of the last PGO run
        self.pgo_event: Optional[Tuple] = None
        self._pending: list = []  # (kp, pose_dev, ok_dev, disp_dev, tick, corr)
        # one-interval-old pending batch: its device values have certainly
        # executed, so the flush's batched fetch does not drain the queue
        self._prev_pending: list = []
        # cumulative world correction (PGO / BA / external pose override);
        # every pending entry snapshots it, and at processing the fetched
        # pose takes the corrections applied while it was in flight
        self._corr_cum: np.ndarray = np.eye(4, dtype=np.float32)
        self._acc_disp = 0.0  # keyframe displacement accumulator (host)
        # FIFO of deferred host decisions whose device work was queued a
        # flush ago: ("retrieve" | "verify" | "ba_fetch" | "ba_apply", payload)
        self._async: list = []
        self._ba_inflight = False  # one BA window in flight at a time
        self._prev: Optional[tuple] = None  # (Keypoints, pose_dev)
        self._summaries = torch.zeros((64, 256), dtype=torch.float32, device=self.device)
        self._edges: list = []  # (i, j, Z np [4,4], weight)
        self.loops_closed = 0
        self.local_ba_runs = 0

    # ---------------------------------------------------------------- pose
    @property
    def pose(self) -> np.ndarray:
        return self._pose.cpu().numpy().copy()

    @pose.setter
    def pose(self, value) -> None:
        old = self.pose
        self._pose = torch.tensor(np.asarray(value, np.float32), device=self.device)
        if self._prev is not None:
            # the next frame composes off the previous frame's pose
            self._prev = (self._prev[0], self._pose)
        if np.all(np.isfinite(old)):
            self._correct_inflight(np.asarray(value, np.float32) @ np.linalg.inv(old))

    def _correct_inflight(self, delta: np.ndarray) -> None:
        """Record a world correction for poses still in the flush pipeline."""
        self._corr_cum = delta.astype(np.float32) @ self._corr_cum

    def _correct_live_pose(self, delta: np.ndarray) -> None:
        """Left-multiply the live pose (and the pose the next frame composes
        off) by a world correction, on the device: one upload, no read."""
        (d,) = _upload(self.device, delta)
        self._pose = d @ self._pose
        if self._prev is not None:
            self._prev = (self._prev[0], self._pose)
        self._correct_inflight(delta)

    # --------------------------------------------------------------- track
    def detect(self, intensity: torch.Tensor, depth: torch.Tensor) -> Keypoints:
        return detect_pyramid(
            intensity, depth, FAST_THRESHOLD_MIN, FAST_THRESHOLD, octaves=self.octaves
        )

    def track(self, intensity: torch.Tensor, depth: torch.Tensor):
        """Process one frame; returns DEVICE values (pose camera-to-world
        [4,4], tracked_ok bool).  Frame-to-frame motion-only GN (the
        constant-velocity front end); keyframes are inserted at the flush
        cadence."""
        with timer.span("sparse.detect"):
            kp = self.detect(intensity, depth)
        if self._prev is None:
            self._prev = (kp, self._pose)
            self._insert_keyframe(kp, self.pose, self.tick)
            self.tick += 1
            return self._pose, torch.ones((), dtype=torch.bool, device=self.device)
        prev_kp, prev_pose = self._prev
        with timer.span("sparse.match_pose"):
            matches, _ = match(prev_kp, kp)
            A, inl, err = motion_only_pose(
                prev_kp, kp, matches, self.intr,
                torch.eye(4, dtype=torch.float32, device=self.device),
            )
            ok = (inl >= 15) & (err < 5.0)
            pose_new = torch.where(ok, prev_pose @ A, self._pose)
            disp = torch.where(ok, torch.linalg.norm(A[:3, 3]), 0.0)
        self._pose = pose_new
        self._prev = (kp, pose_new)
        self._pending.append((kp, pose_new, ok, disp, self.tick, self._corr_cum.copy()))
        self.tick += 1
        if len(self._pending) >= self.flush_interval:
            self.flush(drain=False)
        return pose_new, ok

    # --------------------------------------------------------------- flush
    def flush(self, drain: bool = True) -> None:
        """Advance the host decisions without stalling the device: a
        pipeline lagged by one flush interval, so every value read here was
        queued at least one interval ago.

        Stages per decision: keyframes (one read of the previous interval's
        ok/disp/pose, insertion, retrieval queued); loop closure (retrieval
        read a flush later, verification queued, read the flush after, PGO
        on a confirmed hit); local BA (tables read, tracks built and the
        solve queued, the solve read and applied, one flush each).

        `drain=True` (explicit calls; `track()` passes False) processes
        everything synchronously: end-of-sequence semantics."""
        with timer.span("sparse.flush"):
            batch, self._prev_pending = self._prev_pending, self._pending
            self._pending = []
            if drain:
                batch = batch + self._prev_pending
                self._prev_pending = []
            self._advance_async()
            if batch:
                with timer.span("sparse.keyframes"):
                    self._process_batch(batch)
            if drain:
                while self._async:
                    self._advance_async()

    def _process_batch(self, batch) -> None:
        scal, poses = _fetch(  # ONE read for the whole interval, poses included
            torch.stack([torch.stack([o.to(torch.float32), d]) for _, _, o, d, _, _ in batch]),
            torch.stack([p for _, p, _, _, _, _ in batch]),
        )
        inserted = False
        for (kp, _pd, _o, _d, tick, corr0), (ok_f, disp), pose_np in zip(batch, scal, poses):
            if ok_f < 1.0:
                self._acc_disp = 0.0
                continue
            self._acc_disp += float(disp)
            if self._acc_disp > self.kf_min_disp:
                # bring the in-flight pose into the CURRENT (post-PGO/BA)
                # world: apply the corrections recorded since it was queued
                corr = self._corr_cum @ np.linalg.inv(corr0)
                pose_np = (corr @ np.asarray(pose_np)).astype(np.float32)
                self._schedule_loop_check(kp, pose_np, tick)
                self._insert_keyframe(kp, pose_np, tick)
                inserted = True
                self._acc_disp = 0.0
        if inserted and self.run_local_ba:
            self._schedule_local_ba()

    def _advance_async(self) -> None:
        """Advance every in-flight deferred op by one stage (stages the
        handlers schedule land in the NEXT advance)."""
        ops, self._async = self._async, []
        for kind, payload in ops:
            with timer.span("sparse." + kind):
                getattr(self, "_adv_" + kind)(payload)

    # ----------------------------------------------------------- local BA
    def _schedule_local_ba(self) -> None:
        """Stage 1 of the sliding-window local BA: queue the consecutive-
        keyframe matches and keypoint tables the host builds tracks from;
        they are read one flush later (`_adv_ba_fetch`).  Windows whose
        mean keyframe baseline is below `local_ba_min_baseline` are skipped
        (without parallax the reprojection problem is ambiguous)."""
        if self._ba_inflight:  # overlapping windows would fight on write-back
            return
        W = min(self.local_ba_window, len(self.keyframes))
        if W < 3:
            return
        base = len(self.keyframes) - W
        window = self.keyframes[base:]
        kps = [kf[0] for kf in window]
        poses = np.stack([np.asarray(kf[1]) for kf in window]).astype(np.float32)
        bl = np.mean(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1))
        if bl < self.local_ba_min_baseline:
            return
        handles = (
            torch.stack([match(kps[i - 1], kps[i])[0] for i in range(1, W)]),
            torch.stack([k.uv for k in kps]),
            torch.stack([k.depth for k in kps]),
            torch.stack([k.valid for k in kps]),
        )
        self._ba_inflight = True
        self._async.append(("ba_fetch", dict(base=base, W=W, handles=handles)))

    def _adv_ba_fetch(self, p) -> None:
        """Stage 2: read the match/keypoint tables (queued a flush ago),
        build landmark tracks on the host, and queue the Schur-complement
        solve (`ba.bundle_adjust`).  Landmarks are seeded by depth
        backprojection at their first observation; the first window camera
        is pinned; every observation carries its measured depth (RGB-D
        BA)."""
        W, base = p["W"], p["base"]
        m_np, uv_np, d_np, v_np = _fetch(*p["handles"])
        m_np = m_np.astype(np.int64)
        v_np = v_np > 0.5
        poses = np.stack([np.asarray(self.keyframes[base + i][1]) for i in range(W)]).astype(
            np.float32
        )
        KP = uv_np.shape[1]
        P_CAP = KP  # at most one track per seed keypoint slot
        uvs, deps, vals = list(uv_np), list(d_np), list(v_np)

        track_ids = [np.full(KP, -1, np.int32) for _ in range(W)]
        points = np.zeros((P_CAP, 3), np.float32)
        n_tracks = 0
        fx, fy = self.intr.fx, self.intr.fy
        cx, cy = self.intr.cx, self.intr.cy
        for i in range(W - 1):
            m = m_np[i]
            # a match extends a track only when BOTH endpoints are valid slots
            fwd = (m >= 0) & vals[i] & vals[i + 1][np.maximum(m, 0)]
            has_id = fwd & (track_ids[i] >= 0)
            track_ids[i + 1][m[has_id]] = track_ids[i][has_id]
            # open new tracks at their first matched observation (needs depth)
            new = fwd & (track_ids[i] < 0) & (deps[i] > 0)
            idx_new = np.where(new)[0][: P_CAP - n_tracks]
            if idx_new.size:
                u, v = uvs[i][idx_new, 0], uvs[i][idx_new, 1]
                z = deps[i][idx_new]
                p_cam = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], axis=-1)
                R, t = poses[i][:3, :3], poses[i][:3, 3]
                ids = np.arange(n_tracks, n_tracks + idx_new.size, dtype=np.int32)
                points[ids] = p_cam @ R.T + t
                track_ids[i][idx_new] = ids
                track_ids[i + 1][m[idx_new]] = ids
                n_tracks += idx_new.size
        if n_tracks < 30:
            self._ba_inflight = False
            return

        # flatten the observations (every keyframe slot carrying a track id)
        O_CAP = W * KP
        cam_idx = np.zeros((O_CAP,), np.int64)
        pnt_idx = np.zeros((O_CAP,), np.int64)
        uv_obs = np.zeros((O_CAP, 2), np.float32)
        z_obs = np.zeros((O_CAP,), np.float32)
        valid = np.zeros((O_CAP,), bool)
        o = 0
        for i in range(W):
            sel = np.where((track_ids[i] >= 0) & vals[i])[0]
            n = sel.size
            cam_idx[o : o + n] = i
            pnt_idx[o : o + n] = track_ids[i][sel]
            uv_obs[o : o + n] = uvs[i][sel]
            z_obs[o : o + n] = deps[i][sel]
            valid[o : o + n] = True
            o += n
        if self.mesh is not None:
            # landmark-sharded over the mesh's `cam` group: shard by that
            # group's size, not the whole mesh's (ROADMAP R2)
            points, cam_idx, pnt_idx, uv_obs, valid, z_obs = ba.shard_ba_problem(
                ba.BAProblem(poses, points, cam_idx, pnt_idx, uv_obs, valid, z_obs),
                self.mesh.n_cams,
            )
        poses_d, points_d, cam_d, pnt_d, uv_d, valid_d, z_d = _upload(
            self.device, poses, points, cam_idx, pnt_idx, uv_obs, valid, z_obs
        )
        problem = ba.BAProblem(
            poses=poses_d, points=points_d, cam_idx=cam_d.to(torch.int64),
            pnt_idx=pnt_d.to(torch.int64), uv=uv_d, valid=valid_d > 0.5, z=z_d,
        )
        # the >8 px outlier pregate runs inside the solve (no extra read)
        opts = dict(iters=4, fix_cameras=1, damping=1e-2, huber=3.0, pregate_px=8.0)
        if self.mesh is not None:
            if self._dist_ba is None:
                self._dist_ba = ba.make_distributed_ba(self.mesh, self.intr, **opts)
            out_poses, _pts, _err = self._dist_ba(*problem)
        else:
            out_poses = ba.bundle_adjust(problem, self.intr, **opts)[0].poses
        self._async.append(("ba_apply", dict(base=base, W=W, poses_in=poses, out=out_poses)))

    def _adv_ba_apply(self, p) -> None:
        """Stage 3: read the refined window poses (solve queued a flush ago)
        and apply them: keyframes, the odometry edges between window
        members, and the live pose with the last keyframe's correction."""
        base, W, poses = p["base"], p["W"], p["poses_in"]
        with timer.span("host.read"):
            out = p["out"].cpu().numpy()
        self._ba_inflight = False
        if not np.all(np.isfinite(out)):
            return
        for wi in range(W):
            kp, _, tick = self.keyframes[base + wi]
            self.keyframes[base + wi] = (kp, out[wi], tick)
        for e, (i, j, Z, wgt) in enumerate(self._edges):
            if base <= i < base + W and base <= j < base + W and wgt == 1.0:
                Znew = np.linalg.inv(out[i - base]) @ out[j - base]
                self._edges[e] = (i, j, Znew.astype(np.float32), wgt)
        # the live-pose delta against the estimate AT SOLVE TIME composes
        # correctly though odometry advanced while the solve was in flight
        self._correct_live_pose(out[W - 1] @ np.linalg.inv(poses[W - 1]))
        self.local_ba_runs += 1

    def _insert_keyframe(self, kp: Keypoints, pose_np, tick: int) -> None:
        k = len(self.keyframes)
        if k > 0:
            Z = np.linalg.inv(self.keyframes[-1][1]) @ pose_np
            self._edges.append((k - 1, k, Z.astype(np.float32), 1.0))
        if k >= self._summaries.shape[0]:
            self._summaries = torch.cat([self._summaries, torch.zeros_like(self._summaries)])
        self._summaries[k] = desc_summary(kp)
        self.keyframes.append((kp, np.asarray(pose_np), tick))

    def _schedule_loop_check(self, kp: Keypoints, pose_np, tick: int) -> None:
        """Stage 1 of loop closing: queue summary retrieval (one matvec) for
        the about-to-be-inserted keyframe against the keyframes at least
        `loop_min_gap` ticks older; read one flush later."""
        max_idx = 0
        for i, (_, _, kf_tick) in enumerate(self.keyframes):
            if tick - kf_tick >= self.loop_min_gap:
                max_idx = i + 1
        if max_idx == 0:
            return
        cand = retrieve(self._summaries, len(self.keyframes), desc_summary(kp), max_idx)
        self._async.append(("retrieve", dict(
            kp=kp, pose_np=np.asarray(pose_np).copy(), tick=tick, k=len(self.keyframes),
            cand=cand,
        )))

    def _adv_retrieve(self, p) -> None:
        """Stage 2: read the retrieval scores; for candidates above the
        similarity bar queue geometric verification (Hamming matching +
        motion-only GN), read next flush."""
        cand_idx, cand_sim = _fetch(*p["cand"])
        cands = [int(j) for j, sim in zip(cand_idx, cand_sim) if sim >= 0.35]
        if not cands:
            return
        handles = []
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        for j in cands:
            kf_kp = self.keyframes[j][0]
            matches, _ = match(kf_kp, p["kp"])
            votes = torch.sum((matches >= 0).to(torch.int64))
            A, inl, err = motion_only_pose(kf_kp, p["kp"], matches, self.intr, eye)
            handles += [votes, A, inl, err]
        self._async.append(("verify", dict(
            handles=handles, cands=cands, **{key: p[key] for key in ("pose_np", "tick", "k")}
        )))

    def _adv_verify(self, p) -> None:
        """Stage 3: read all candidates' verification results in one
        transfer; on a confirmed hit add the loop edge and run PGO (rare;
        this one blocks)."""
        fetched = _fetch(*p["handles"])
        hit = None
        for c, j in enumerate(p["cands"]):
            votes, A, inl, err = fetched[4 * c : 4 * c + 4]
            if int(votes) < self.loop_min_votes:
                continue
            if int(inl) < 20 or float(err) >= 4.0:
                continue
            hit = (j, A.astype(np.float32))
            break
        if hit is None:
            return
        j, A = hit
        k = p["k"]  # the keyframe this check belongs to (already inserted)
        if k >= len(self.keyframes):
            return
        # the corrected pose of keyframe k implied by the match against j's
        # CURRENT pose; the drifted half is k's CURRENT estimate
        kf_pose = np.asarray(self.keyframes[j][1])
        corrected = (kf_pose @ A).astype(np.float32)
        pose_est = np.asarray(self.keyframes[k][1]).astype(np.float32).copy()
        self.last_loop = (pose_est, corrected)
        self.last_loop_tick = p["tick"]  # the loop keyframe's tick
        self.loops_closed += 1
        self._edges.append((j, k, A, 3.0))
        if self.run_pgo:
            with timer.span("sparse.pgo"):
                self._optimise_graph(k=k, corrected=corrected, old_pose=pose_est, anchor_idx=j)

    def _optimise_graph(
        self, k: int, corrected: np.ndarray, old_pose: np.ndarray, anchor_idx: int
    ) -> None:
        """Pose-graph GN over all keyframes (odometry + loop edges,
        `ba.optimise_pose_graph`); keyframe poses and the live pose are
        rewritten from the optimum.

        `k` is the loop's NEW keyframe, `corrected` its loop-implied pose
        and `old_pose` its PRE-correction estimate.  The loop correction is
        first spread in se(3) along the chain from `anchor_idx` (the loop's
        old keyframe) to `k` (later keyframes take all of it), so that GN
        starts inside its basin; CG then polishes locally."""
        K = len(self.keyframes)
        poses = np.stack([p for _, p, _ in self.keyframes]).astype(np.float32)
        poses_orig = poses.copy()
        poses[k] = corrected
        C = (corrected @ np.linalg.inv(old_pose)).astype(np.float32)
        xi = se3.se3_log(torch.from_numpy(C)).numpy()
        span = max(k - anchor_idx, 1)
        for idx in range(anchor_idx + 1, K):
            if idx == k:
                continue
            s = min((idx - anchor_idx) / span, 1.0)
            D = se3.se3_exp(torch.from_numpy((s * xi).astype(np.float32))).numpy()
            poses[idx] = D @ poses[idx]
        # pad to power-of-two capacity (as the reference, whose compiles
        # this bounds)
        Kcap = 8
        while Kcap < K:
            Kcap *= 2
        Ecap = edge_capacity(len(self._edges), 1 if self.mesh is None else self.mesh.n_cams)
        poses_p = np.tile(np.eye(4, dtype=np.float32), (Kcap, 1, 1))
        poses_p[:K] = poses
        ei = np.zeros((Ecap,), np.int64)
        ej = np.zeros((Ecap,), np.int64)
        Z = np.tile(np.eye(4, dtype=np.float32), (Ecap, 1, 1))
        w = np.zeros((Ecap,), np.float32)
        for e, (i, j, Ze, we) in enumerate(self._edges):
            ei[e], ej[e], Z[e], w[e] = i, j, Ze, we
        poses_d, ei_d, ej_d, Z_d, w_d = _upload(self.device, poses_p, ei, ej, Z, w)
        edges = ba.PoseGraphEdges(
            i=ei_d.to(torch.int64), j=ej_d.to(torch.int64), Z=Z_d, weight=w_d
        )
        if self.mesh is not None:
            if self._dist_pgo is None:
                self._dist_pgo = ba.make_distributed_pgo(self.mesh, cg_iters=128)
            out, _err = self._dist_pgo(poses_d, edges)
        else:
            out, _err = ba.optimise_pose_graph(poses_d, edges, cg_iters=128)
        with timer.span("host.read"):
            out = out.cpu().numpy()
        # the per-keyframe corrections (from the ORIGINAL poses), so the
        # engine can rewrite its dense trajectory to the optimum
        self.pgo_event = (
            np.array([t for _, _, t in self.keyframes], np.int64),
            poses_orig[:K].copy(),
            out[:K].copy(),
        )
        for idx in range(K):
            kp, _, tick = self.keyframes[idx]
            self.keyframes[idx] = (kp, out[idx], tick)
        # the live pose takes the LAST keyframe's correction, measured from
        # its pre-warm-start estimate; poses in flight take the same
        self._correct_live_pose(out[K - 1] @ np.linalg.inv(poses_orig[K - 1]))
        if self.last_loop is not None:
            # the hybrid pair's corrected half is keyframe k's OPTIMISED pose
            self.last_loop = (self.last_loop[0], out[k].astype(np.float32))

    def pop_loop(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(pose_old_estimate, pose_corrected) pair, once."""
        out, self.last_loop = self.last_loop, None
        return out

    def pop_pgo_event(self) -> Optional[Tuple]:
        """(kf_ticks, kf_poses_before, kf_poses_after) of the last pose-graph
        optimisation, once."""
        out, self.pgo_event = self.pgo_event, None
        return out

