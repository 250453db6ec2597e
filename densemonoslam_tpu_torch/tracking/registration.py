"""Wide-baseline global registration (port of
`densemonoslam_tpu.tracking.registration`): the role of the reference's Fast
Global Registration, initialisation-free alignment of two RGB-D views.

- Correspondences come from the sparse tracker's ORB features (FAST +
  steered BRIEF, mutual-best Hamming matching).
- The rigid transform is solved by graduated non-convexity over the
  Geman-McClure cost, FGR's line-process iteration: a closed-form weighted
  Kabsch alignment alternating with weights ``w_i = (mu / (mu + r_i^2))^2``
  while ``mu`` anneals from coarse to fine.

`torch.linalg.svd` may return singular vectors with other signs than the
reference's; the determinant correction makes R the same either way.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.tracking import sparse

GNC_ITERS = 32
MU_INIT = 1.0  # metres^2; annealed /1.4 per iteration (FGR's division by 1.4)
MU_MIN = 1e-4


def _backproject_kp(kp: sparse.Keypoints, intr: CameraIntrinsics) -> torch.Tensor:
    u, v, z = kp.uv[:, 0], kp.uv[:, 1], kp.depth
    return torch.stack([(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z, z], dim=-1)


def _weighted_kabsch(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid T minimising sum w_i ||T P_i - Q_i||^2."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    mu_p = (w[:, None] * P).sum(dim=0) / wsum
    mu_q = (w[:, None] * Q).sum(dim=0) / wsum
    H = torch.einsum("n,ni,nj->ij", w, P - mu_p, Q - mu_q)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    T = torch.eye(4, dtype=P.dtype, device=P.device)
    T[:3, :3] = R
    T[:3, 3] = mu_q - R @ mu_p
    return T


def gnc_rigid_align(
    P: torch.Tensor,  # [N, 3] source points
    Q: torch.Tensor,  # [N, 3] target points
    valid: torch.Tensor,  # [N] bool
    iters: int = GNC_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Graduated-non-convexity robust rigid alignment (FGR's line process).

    Returns (T mapping P to Q, inlier count at the final scale, rms inlier
    residual), all on the device."""
    base = valid.to(torch.float32)
    T = torch.eye(4, dtype=torch.float32, device=P.device)
    mu = MU_INIT
    for _ in range(iters):
        r2 = torch.square(P @ T[:3, :3].T + T[:3, 3] - Q).sum(dim=-1)
        w = torch.square(mu / (mu + r2)) * base  # the Geman-McClure line process
        T_new = _weighted_kabsch(P, Q, w)
        T = torch.where(torch.isfinite(T_new).all(), T_new, T)
        mu = max(float(np.float32(mu) / np.float32(1.4)), MU_MIN)  # f32, as the reference
    r2 = torch.square(P @ T[:3, :3].T + T[:3, 3] - Q).sum(dim=-1)
    inl = base * (r2 < 9.0 * MU_MIN)
    n_inl = inl.sum()
    rms = torch.sqrt((r2 * inl).sum() / torch.clamp(n_inl, min=1.0))
    return T, n_inl, rms


def global_registration(
    intensity_a: torch.Tensor,
    depth_a: torch.Tensor,
    intensity_b: torch.Tensor,
    depth_b: torch.Tensor,
    intr_a: CameraIntrinsics,
    intr_b: CameraIntrinsics,
    fast_threshold: float = 5.0,
) -> Tuple[torch.Tensor, float, float]:
    """Initialisation-free alignment of two RGB-D views, each backprojected
    with its own intrinsics.

    Returns (T mapping view-a camera coordinates into view b's, inlier
    count, rms residual); the caller gates acceptance on the last two.  One
    host read (those two)."""
    kp_a = sparse.detect_and_describe(intensity_a, depth_a, threshold=fast_threshold)
    kp_b = sparse.detect_and_describe(intensity_b, depth_b, threshold=fast_threshold)
    matches, _ = sparse.match(kp_a, kp_b)
    m_safe = torch.clamp(matches, min=0)
    P = _backproject_kp(kp_a, intr_a)
    Q = _backproject_kp(kp_b, intr_b)[m_safe]
    valid = (matches >= 0) & kp_a.valid & (kp_a.depth > 0.05) & (kp_b.depth[m_safe] > 0.05)
    T, n_inl, rms = gnc_rigid_align(P, Q, valid)
    n_inl, rms = torch.stack([n_inl, rms]).tolist()
    return T, n_inl, rms
