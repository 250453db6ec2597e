"""Trajectory evaluation: ATE (absolute trajectory error) and RPE.

The reference evaluates offline with the TUM benchmark scripts against
`.freiburg` ground truth written by its converters
(`logs/kitti/kitti_odom_to_lcm.py:177-181`).  We implement the same metrics
in-repo so CI can gate accuracy: Horn/Umeyama alignment + RMSE of translation
residuals (optionally with scale for monocular runs, as KITTI mono evaluation
requires)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning est -> gt (positions [N,3]).

    Returns (R, t, s) with gt ~= s * R @ est + t.
    """
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    with_scale: bool = False,
) -> float:
    """RMSE of translation error after Umeyama alignment (TUM ATE)."""
    est = np.stack([np.asarray(T)[:3, 3] for T in est_poses])
    gt = np.stack([np.asarray(T)[:3, 3] for T in gt_poses])
    R, t, s = align_umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = aligned - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error over a fixed frame delta.

    Returns (trans RMSE in metres, rot RMSE in radians)."""
    terr, rerr = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(np.asarray(est_poses[i])) @ np.asarray(est_poses[i + delta])
        dg = np.linalg.inv(np.asarray(gt_poses[i])) @ np.asarray(gt_poses[i + delta])
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )
