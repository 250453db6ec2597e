"""Gauss-Newton normal-equation builders for dense tracking (port of
`densemonoslam_tpu.ops.reductions`).

Each pixel contributes one masked row ``M[p] = [J_p (6) | r_p | m_p]`` and the
normal-equation bundle of a step is the Gram matrix ``G = M^T M``
(`ops.gram.gram`, kernel K1 on the GPU):

- ``G[:6,:6]`` = JtJ,   ``G[:6, 6]`` = -Jtb (we solve JtJ xi = -Jtr),
- ``G[6, 6]``  = sum of squared residuals,   ``G[7, 7]`` = inlier count.

Tracking estimates the relative transform ``A`` (current camera -> model
camera) with the left update ``A <- exp(xi) A``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import geometry
# `gram` is also `reductions.gram`, as the JAX package names it
from densemonoslam_tpu_torch.ops.gram import gram
from densemonoslam_tpu_torch.utils import se3

# Association gates, the reference ICP kernel's values (distThres 0.10 m,
# angleThres sin(20 deg)).
ICP_DIST_THRESH = 0.10
ICP_ANGLE_SIN_THRESH = 0.34202
RGB_MIN_GRAD = 1.0  # intensity gradient magnitude gate, [0,255] units
RGB_MAX_RESIDUAL = 255.0  # photometric residual gate, [0,255] units
OCCLUSION_THRESH = 0.15  # metres between the warped and the model depth
# How far (pixels) a row may drift from a frozen sample's position before
# it is gated out: the GN levels' and the SO3 pre-align's.
GN_DRIFT_PX = 2.0
SO3_DRIFT_PX = 3.0
# Tracking's solver settings (`tracking.odometry`, and `ops.track_iter` on
# the card): damping, the inliers an update needs, and the squared step
# below which iterating stops; for the GN levels and the SO3 pre-align.
GN_DAMPING, GN_MIN_INLIERS, GN_STEP_TOL = 1e-8, 10.0, 1e-9
SO3_DAMPING, SO3_MIN_INLIERS, SO3_STEP_TOL = 1e-4, 50.0, 1e-10

class GramStats(NamedTuple):
    """Unpacked Gram-matrix results for one GN step."""

    JtJ: torch.Tensor  # [6,6]
    Jtr: torch.Tensor  # [6]
    residual_sq: torch.Tensor  # scalar, sum r^2
    inliers: torch.Tensor  # scalar, number of rows that passed the gates


def unpack_gram(G: torch.Tensor) -> GramStats:
    return GramStats(JtJ=G[:6, :6], Jtr=G[:6, 6], residual_sq=G[6, 6], inliers=G[7, 7])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _image_grad_rows(p, gx, gy, intr: CameraIntrinsics) -> torch.Tensor:
    """For a camera-frame point p and image gradient (gx, gy) at its
    projection, the 3-vector g3 with ``dr = g3 . dp``."""
    z = torch.clamp(p[..., 2], min=1e-6)
    a = gx * intr.fx / z
    b = gy * intr.fy / z
    c = -(a * p[..., 0] + b * p[..., 1]) / z
    return torch.stack([a, b, c], dim=-1)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant)."""
    r0, r1, r2 = M[0], M[1], M[2]
    c0 = _cross(r1, r2)
    c1 = _cross(r2, r0)
    c2 = _cross(r0, r1)
    det = torch.dot(r0, c0)
    return torch.stack([c0, c1, c2], dim=-1) / det


def solve_se3(JtJ: torch.Tensor, Jtr: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve ``JtJ xi = -Jtr`` via a 3x3 block Schur complement with
    closed-form 3x3 inverses."""
    Areg = JtJ + damping * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    b = -Jtr
    P, Q, S = Areg[:3, :3], Areg[:3, 3:], Areg[3:, 3:]
    Pinv = _inv3(P)
    T = Pinv @ Q
    S_schur = S - Q.T @ T
    y1p = Pinv @ b[:3]
    x2 = _inv3(S_schur) @ (b[3:] - Q.T @ y1p)
    x1 = y1p - T @ x2
    return torch.cat([x1, x2])


def solve_so3(JtJ3: torch.Tensor, Jtr3: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    Areg = JtJ3 + damping * torch.eye(3, dtype=JtJ3.dtype, device=JtJ3.device)
    return _inv3(Areg) @ (-Jtr3)


def diag_inv_6x6(A: torch.Tensor, damping: float = 1e-12) -> torch.Tensor:
    """diag(A^-1) for an SPD 6x6 via the same block Schur complement."""
    Areg = A + damping * torch.eye(6, dtype=A.dtype, device=A.device)
    P, Q, S = Areg[:3, :3], Areg[:3, 3:], Areg[3:, 3:]
    Pinv = _inv3(P)
    M = Pinv @ Q
    Ssc_inv = _inv3(S - Q.T @ M)
    top = torch.diagonal(Pinv) + torch.sum((M @ Ssc_inv) * M, dim=-1)
    return torch.cat([top, torch.diagonal(Ssc_inv)])


def combined_system(
    M_icp: torch.Tensor, M_rgb: torch.Tensor, icp_weight: float, rgb_scale: float = 1.0
) -> Tuple[GramStats, GramStats, torch.Tensor, torch.Tensor]:
    """Joint ICP+RGB normal equations ``A_rgb + w^2 A_icp`` from ONE [P,16]
    Gram: its diagonal 8x8 blocks are gram(M_icp) and gram(M_rgb)."""
    G = gram(torch.cat([M_icp, M_rgb], dim=-1))
    G_icp = unpack_gram(G[:8, :8])
    G_rgb = unpack_gram(G[8:, 8:])
    w2 = icp_weight * icp_weight
    JtJ = rgb_scale * G_rgb.JtJ + w2 * G_icp.JtJ
    Jtr = rgb_scale * G_rgb.Jtr + w2 * G_icp.Jtr
    return G_icp, G_rgb, JtJ, Jtr


# ---------------------------------------------------------------------------
# Packed-sampling row builders: every model attribute lives in one
# [H, W, 12] tensor, fetched with one row gather per bilinear corner:
#   channels 0:3 vertex, 3:6 normal (corner-selected, "nearest"),
#   6 intensity, 7 grad_x, 8 grad_y, 9 z (bilinearly blended), 10:12 pad.
# ---------------------------------------------------------------------------

def pack_model(vmap_m, nmap_m, intensity_m, gx_m, gy_m) -> torch.Tensor:
    """[H,W,*] model maps -> packed [H, W, 12] sampling tensor."""
    H, W, _ = vmap_m.shape
    pad = torch.zeros((H, W, 2), dtype=torch.float32, device=vmap_m.device)
    return torch.cat(
        [vmap_m, nmap_m, intensity_m[..., None], gx_m[..., None], gy_m[..., None],
         vmap_m[..., 2:3], pad],
        dim=-1,
    )


class ModelSample(NamedTuple):
    v_m: torch.Tensor  # [P,3] corner-selected vertex
    n_m: torch.Tensor  # [P,3] corner-selected normal
    i_m: torch.Tensor  # [P] bilinear intensity
    gx: torch.Tensor  # [P]
    gy: torch.Tensor  # [P]
    z_m: torch.Tensor  # [P] bilinear model depth
    inb: torch.Tensor  # [P] bool in-bounds


def sample_model(
    pack: torch.Tensor, u: torch.Tensor, v: torch.Tensor, bilinear: bool = True
) -> ModelSample:
    """Sample the packed model at float pixel coords (u, v) [P];
    `bilinear=False` fetches only the nearest row."""
    H, W, C = pack.shape
    flat = pack.reshape(H * W, C)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    uc = torch.clamp(u, 0.0, W - 1.001)
    vc = torch.clamp(v, 0.0, H - 1.001)
    if not bilinear:
        near = flat[torch.round(vc).long() * W + torch.round(uc).long()]
        return ModelSample(
            v_m=near[:, 0:3], n_m=near[:, 3:6], i_m=near[:, 6],
            gx=near[:, 7], gy=near[:, 8], z_m=near[:, 9], inb=inb,
        )
    u0 = torch.floor(uc).long()
    v0 = torch.floor(vc).long()
    fu = (uc - u0.to(torch.float32))[:, None]
    fv = (vc - v0.to(torch.float32))[:, None]
    base = v0 * W + u0
    c00 = flat[base]
    c01 = flat[base + 1]
    c10 = flat[base + W]
    c11 = flat[base + W + 1]
    bil = (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )
    right = (fu > 0.5)
    down = (fv > 0.5)
    near = torch.where(down, torch.where(right, c11, c10), torch.where(right, c01, c00))
    return ModelSample(
        v_m=near[:, 0:3], n_m=near[:, 3:6], i_m=bil[:, 6],
        gx=bil[:, 7], gy=bil[:, 8], z_m=bil[:, 9], inb=inb,
    )


def _icp_block(p, n_c, n_c_raw, valid_c, inb, v_m, n_m, dist_thresh, angle_thresh):
    """Point-to-plane rows ``[(p x n_m), n_m, r, 1]``, ``r = n_m . (p - v_m)``,
    for current points p associated with model points (v_m, n_m)."""
    valid_m = v_m[:, 2] > 0
    diff = p - v_m
    dist = torch.linalg.norm(diff, dim=-1)
    sin_angle = torch.linalg.norm(_cross(n_c, n_m), dim=-1)
    has_n = torch.linalg.norm(n_c_raw, dim=-1) > 0.5
    mask = valid_c & inb & valid_m & has_n & (dist < dist_thresh) & (sin_angle < angle_thresh)
    r = torch.sum(n_m * diff, dim=-1)
    Jw = _cross(p, n_m)
    M = torch.cat([Jw, n_m, r[:, None], torch.ones_like(r)[:, None]], dim=-1)
    return M * mask.to(torch.float32)[:, None]


def _rgb_block(p, r, g_mask, gx, gy, intr):
    g3 = _image_grad_rows(p, gx, gy, intr)
    Jw = _cross(p, g3)
    M = torch.cat([Jw, g3, r[:, None], torch.ones_like(r)[:, None]], dim=-1)
    return M * g_mask.to(torch.float32)[:, None]


def joint_rows_packed(
    vmap_c: torch.Tensor,  # [H,W,3]
    nmap_c: torch.Tensor,
    intensity_c: torch.Tensor,  # [H,W]
    model_pack: torch.Tensor,  # [H,W,12]
    A: torch.Tensor,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = RGB_MAX_RESIDUAL,
    occlusion_thresh: float = OCCLUSION_THRESH,
    bilinear: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICP and RGB row matrices (M_icp [P,8], M_rgb [P,8]) from one packed
    model sample at the current estimate (exact re-association)."""
    H, W, _ = vmap_c.shape
    P = H * W
    v_c = vmap_c.reshape(P, 3)
    n_c_raw = nmap_c.reshape(P, 3)
    valid_c = v_c[:, 2] > 0
    p = se3.transform_points(A, v_c)
    n_c = se3.rotate_vectors(A, n_c_raw)
    u, v, z = geometry.project(p, intr)
    smp = sample_model(model_pack, u, v, bilinear=bilinear)
    inb = smp.inb & (z > 0)
    M_icp = _icp_block(
        p, n_c, n_c_raw, valid_c, inb, smp.v_m, smp.n_m, dist_thresh, angle_thresh
    )
    r_rgb = smp.i_m - intensity_c.reshape(P)
    gmag2 = smp.gx * smp.gx + smp.gy * smp.gy
    mask_rgb = (
        valid_c & inb
        & (gmag2 > min_grad * min_grad)
        & (torch.abs(r_rgb) < max_residual)
        & (smp.z_m > 0)
        & (torch.abs(z - smp.z_m) < occlusion_thresh)
    )
    return M_icp, _rgb_block(p, r_rgb, mask_rgb, smp.gx, smp.gy, intr)


def joint_rows_frozen(
    v_c: torch.Tensor,  # [P,3] current-frame vertices (camera frame)
    n_c_raw: torch.Tensor,  # [P,3]
    i_c: torch.Tensor,  # [P]
    smp: ModelSample,  # model sampled ONCE at uv0 = project(A0 v_c)
    uv0: torch.Tensor,  # [P,2] the sample positions
    A: torch.Tensor,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = RGB_MAX_RESIDUAL,
    occlusion_thresh: float = OCCLUSION_THRESH,
    drift_px: float = GN_DRIFT_PX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICP+RGB rows against a FROZEN model sample (Lucas-Kanade style): the
    ICP association stays fixed, the RGB residual is linearised around uv0,
    and rows that drift more than `drift_px` from uv0 are gated out."""
    valid_c = v_c[:, 2] > 0
    p = se3.transform_points(A, v_c)
    n_c = se3.rotate_vectors(A, n_c_raw)
    u, v, z = geometry.project(p, intr)
    inb = smp.inb & (z > 0)
    du = u - uv0[:, 0]
    dv = v - uv0[:, 1]
    near = (torch.abs(du) <= drift_px) & (torch.abs(dv) <= drift_px)
    M_icp = _icp_block(
        p, n_c, n_c_raw, valid_c, inb & near, smp.v_m, smp.n_m, dist_thresh, angle_thresh
    )
    r_rgb = (smp.i_m + smp.gx * du + smp.gy * dv) - i_c
    gmag2 = smp.gx * smp.gx + smp.gy * smp.gy
    mask_rgb = (
        valid_c & inb & near
        & (gmag2 > min_grad * min_grad)
        & (torch.abs(r_rgb) < max_residual)
        & (smp.z_m > 0)
        & (torch.abs(z - smp.z_m) < occlusion_thresh)
    )
    return M_icp, _rgb_block(p, r_rgb, mask_rgb, smp.gx, smp.gy, intr)


def _so3_block(rd, r, mask, gx, gy, intr):
    g3 = _image_grad_rows(rd, gx, gy, intr)
    Jw = _cross(rd, g3)
    zeros = torch.zeros_like(r)[:, None]
    M = torch.cat(
        [Jw, r[:, None], zeros, zeros, zeros, torch.ones_like(r)[:, None]], dim=-1
    )
    return M * mask.to(torch.float32)[:, None]


def so3_rows_frozen(
    d: torch.Tensor,  # [P,3] unit-plane rays (fixed per level)
    i_c: torch.Tensor,  # [P] current intensities
    smp: ModelSample,  # model sampled ONCE at uv0 = project(R0 d)
    uv0: torch.Tensor,  # [P,2]
    R: torch.Tensor,
    intr: CameraIntrinsics,
    max_residual: float = RGB_MAX_RESIDUAL,
    drift_px: float = SO3_DRIFT_PX,
) -> torch.Tensor:
    """SO3 photometric rows [P,8] against a FROZEN model sample."""
    rd = torch.sum(R * d[:, None, :], dim=-1)
    u, v, z = geometry.project(rd, intr)
    du = u - uv0[:, 0]
    dv = v - uv0[:, 1]
    near = (torch.abs(du) <= drift_px) & (torch.abs(dv) <= drift_px)
    r = (smp.i_m + smp.gx * du + smp.gy * dv) - i_c
    mask = smp.inb & near & (z > 0) & (torch.abs(r) < max_residual)
    return _so3_block(rd, r, mask, smp.gx, smp.gy, intr)


def unit_rays(H: int, W: int, intr: CameraIntrinsics, device) -> torch.Tensor:
    """[H*W, 3] rays with unit z through every pixel centre."""
    uu = torch.arange(W, dtype=torch.float32, device=device).expand(H, W).reshape(-1)
    vv = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W).reshape(-1)
    return torch.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, torch.ones_like(uu)], dim=-1
    )


def so3_rows_packed(
    intensity_c: torch.Tensor,
    model_pack: torch.Tensor,
    R: torch.Tensor,
    intr: CameraIntrinsics,
    max_residual: float = RGB_MAX_RESIDUAL,
) -> torch.Tensor:
    """Rotation-only homography-warp rows [P,8] (exact re-association)."""
    H, W = intensity_c.shape
    rd = torch.sum(R * unit_rays(H, W, intr, intensity_c.device)[:, None, :], dim=-1)
    u, v, z = geometry.project(rd, intr)
    smp = sample_model(model_pack, u, v)
    r = smp.i_m - intensity_c.reshape(H * W)
    mask = smp.inb & (z > 0) & (torch.abs(r) < max_residual)
    return _so3_block(rd, r, mask, smp.gx, smp.gy, intr)


# ---------------------------------------------------------------------------
# Per-pixel rows with separate samples of each model map: the reference's own
# row formulation (ICP, RGB and SO3 reductions), from which the packed and
# frozen builders above are derived; the oracle the tests differentiate.
# ---------------------------------------------------------------------------

def icp_rows(
    vmap_c: torch.Tensor,
    nmap_c: torch.Tensor,
    vmap_m: torch.Tensor,
    nmap_m: torch.Tensor,
    A: torch.Tensor,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
) -> torch.Tensor:
    """Point-to-plane ICP rows [H*W, 8] with projective data association:
    each current vertex goes into the model frame by A, is projected, and
    meets the model vertex and normal at the nearest pixel; the distance and
    normal-angle gates zero the rows that fail them.  All maps [H, W, 3]."""
    H, W, _ = vmap_c.shape
    v_c = vmap_c.reshape(-1, 3)
    n_c_raw = nmap_c.reshape(-1, 3)
    p = se3.transform_points(A, v_c)
    n_c = se3.rotate_vectors(A, n_c_raw)
    u, v, z = geometry.project(p, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    v_m = geometry.nearest_sample(vmap_m, u, v)
    n_m = geometry.nearest_sample(nmap_m, u, v)
    return _icp_block(p, n_c, n_c_raw, v_c[:, 2] > 0, inb, v_m, n_m, dist_thresh, angle_thresh)


def rgb_rows(
    vmap_c: torch.Tensor,
    intensity_c: torch.Tensor,
    intensity_m: torch.Tensor,
    grad_mx: torch.Tensor,
    grad_my: torch.Tensor,
    A: torch.Tensor,
    intr: CameraIntrinsics,
    depth_m: torch.Tensor | None = None,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = RGB_MAX_RESIDUAL,
    occlusion_thresh: float = OCCLUSION_THRESH,
) -> torch.Tensor:
    """Photometric rows [H*W, 8] ``[(p x g3), g3, r, 1]`` for
    ``r = I_m(pi(A v_c)) - I_c``: model intensity and Sobel gradients sampled
    bilinearly at each warped current pixel.  With `depth_m` ([H,W] model
    z-depth), pixels whose warped depth is more than `occlusion_thresh` from
    the model's are gated out as occlusions."""
    H, W, _ = vmap_c.shape
    v_c = vmap_c.reshape(-1, 3)
    p = se3.transform_points(A, v_c)
    u, v, z = geometry.project(p, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    gx = geometry.bilinear_sample(grad_mx, u, v)
    gy = geometry.bilinear_sample(grad_my, u, v)
    r = geometry.bilinear_sample(intensity_m, u, v) - intensity_c.reshape(-1)
    mask = (
        (v_c[:, 2] > 0) & inb
        & (gx * gx + gy * gy > min_grad * min_grad)
        & (torch.abs(r) < max_residual)
    )
    if depth_m is not None:
        z_m = geometry.nearest_sample(depth_m, u, v)
        mask = mask & (z_m > 0) & (torch.abs(z - z_m) < occlusion_thresh)
    return _rgb_block(p, r, mask, gx, gy, intr)


def so3_rows(
    intensity_c: torch.Tensor,
    intensity_m: torch.Tensor,
    grad_mx: torch.Tensor,
    grad_my: torch.Tensor,
    R: torch.Tensor,
    intr: CameraIntrinsics,
    min_grad: float = 0.0,
    max_residual: float = RGB_MAX_RESIDUAL,
) -> torch.Tensor:
    """Rotation-only photometric rows [H*W, 8] ``[Jw (3), r, 0, 0, 0, 1]``:
    each unit-z ray is rotated by R and projected (the homography warp
    between the coarsest levels); G[:3,:3] = JtJ, G[:3,3] = Jtr,
    G[3,3] = sum r^2, G[7,7] = count."""
    H, W = intensity_c.shape
    rd = torch.sum(R * unit_rays(H, W, intr, intensity_c.device)[:, None, :], dim=-1)
    u, v, z = geometry.project(rd, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    gx = geometry.bilinear_sample(grad_mx, u, v)
    gy = geometry.bilinear_sample(grad_my, u, v)
    r = geometry.bilinear_sample(intensity_m, u, v) - intensity_c.reshape(-1)
    mask = inb & (gx * gx + gy * gy >= min_grad * min_grad) & (torch.abs(r) < max_residual)
    return _so3_block(rd, r, mask, gx, gy, intr)
