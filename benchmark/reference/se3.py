"""SO(3)/SE(3) Lie-group utilities on torch tensors (port of
`densemonoslam_tpu.utils.se3`).

Conventions are the reference package's:
- a pose is a 4x4 camera-to-world matrix ``T`` (``p_world = T @ [p_cam, 1]``);
- a twist is ``xi = (omega[3], v[3])`` with the left update ``T <- exp(xi) @ T``.

Small-angle branches are selected with `torch.where`, so every function is
branch-free on the host and works on batched inputs.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from rotation [..., 3, 3] and translation [..., 3], built
    on the device (no host-to-device copy of the constant bottom row)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # not `= 1.0`: that copies a host scalar (a sync)
    return T


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(theta2: torch.Tensor):
    """(small mask, sin(t)/t, (1-cos t)/t^2, safe t^2) with series fallbacks."""
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    return small, a, b, theta2_safe


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula exp: R^3 -> SO(3), with a Taylor branch near 0."""
    _, a, b, _ = _exp_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> R^3 (rotation vector), for [..., 3, 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = c > 1.0 - 1e-5
    c_safe = torch.where(small, torch.zeros_like(c), c)
    theta = torch.arccos(c_safe)
    w_hat = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    one_m_c = torch.clamp(1.0 - c, min=0.0)
    scale_small = 0.5 + one_m_c / 6.0 + one_m_c * one_m_c * (7.0 / 90.0)
    scale_big = theta / (2.0 * torch.sin(theta) + _EPS)
    scale = torch.where(small, scale_small, scale_big)
    return scale[..., None] * w_hat


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp: R^6 (omega, v) -> SE(3) 4x4 matrix."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small, a, b, theta2_safe = _exp_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return _rigid(R, torch.einsum("...ij,...j->...i", V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> R^6 (omega, v), for [..., 4, 4]."""
    t = T[..., :3, 3]
    w = so3_log(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    small, a, b, theta2_safe = _exp_coeffs(theta2)
    W = hat(w)
    # V^{-1} = I - 0.5 W + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * torch.clamp(b, min=1e-12))) / theta2_safe,
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, torch.einsum("...ij,...j->...i", Vinv, t)], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 inverse."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _rigid(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to points [..., 3] (broadcast multiply-add,
    the reference package's exact-f32 elementwise form)."""
    return torch.sum(T[:3, :3] * p[..., None, :], dim=-1) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of a 4x4 transform to vectors [..., 3]."""
    return torch.sum(T[:3, :3] * n[..., None, :], dim=-1)


def apply_update(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative GN update ``T <- exp(xi) @ T``."""
    return se3_exp(xi) @ T


def orthonormalise(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD, with the determinant fix
    that keeps the result a proper rotation."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * d[..., None, :]) @ vt


def pose_distance(Ta: torch.Tensor, Tb: torch.Tensor):
    """(rotation angle, translation distance) between two poses."""
    dT = se3_inverse(Ta) @ Tb
    w = so3_log(dT[:3, :3])
    return torch.linalg.norm(w), torch.linalg.norm(dT[:3, 3])
