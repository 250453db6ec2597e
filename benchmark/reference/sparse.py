"""The sparse tracker's frame chain, plain: FAST corners and steered BRIEF
over a scale pyramid (`detect_pyramid`), mutual-best Hamming matching with
a ratio test (`match`) and motion-only Gauss-Newton on reprojection errors
(`motion_only_pose`), as the program's `tracking/sparse.py` computes them
(a frozen copy of its functions; the tracker's keyframes, loop detection
and bundle adjustment are not here)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import se3
from .config import CameraIntrinsics

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
