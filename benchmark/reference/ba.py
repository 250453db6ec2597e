"""The sparse tracker's local bundle adjustment, plain (port of the
program's `parallel/ba.py` `bundle_adjust` on one device and of the host
track building of `tracking/sparse.py`'s `_adv_ba_fetch`, frozen): the
window's consecutive keyframes matched, landmark tracks opened at their
first matched observation with depth, and the Schur-complement solve over
cameras and points with the depth residual, the outlier pregate and the
Huber weight the tracker asks for."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import se3, sparse
from .config import CameraIntrinsics

# the tracker's solve (`SparseTracker._adv_ba_fetch`)
OPTS = dict(iters=4, fix_cameras=1, damping=1e-2, huber=3.0, pregate_px=8.0)
MIN_TRACKS = 30  # a window with fewer tracks is not solved


class BAProblem(NamedTuple):
    poses: torch.Tensor  # [K, 4, 4] camera-to-world
    points: torch.Tensor  # [P, 3] world
    cam_idx: torch.Tensor  # [O] int64
    pnt_idx: torch.Tensor  # [O] int64
    uv: torch.Tensor  # [O, 2]
    valid: torch.Tensor  # [O] bool
    z: Optional[torch.Tensor] = None  # [O] measured depth (0 = none)


def _apply_xi(poses: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return torch.einsum("kij,kjl->kil", poses, se3.se3_exp(xi))


def _project(pose: torch.Tensor, X: torch.Tensor, intr: CameraIntrinsics):
    Tinv = se3.se3_inverse(pose)
    p = torch.einsum("oij,oj->oi", Tinv[:, :3, :3], X) + Tinv[:, :3, 3]
    z = torch.clamp(p[:, 2], min=1e-6)
    return torch.stack([p[:, 0] / z * intr.fx + intr.cx, p[:, 1] / z * intr.fy + intr.cy], -1), p


def _ba_blocks(poses, points, cam_idx, pnt_idx, uv, valid, intr, z_obs=None):
    O = cam_idx.shape[0]
    dev = poses.device
    pose = poses[cam_idx]
    X = points[pnt_idx]
    with torch.enable_grad():
        xi = torch.zeros((O, 6), dtype=torch.float32, device=dev, requires_grad=True)
        dX = torch.zeros((O, 3), dtype=torch.float32, device=dev, requires_grad=True)
        proj, p = _project(pose @ se3.se3_exp(xi), X + dX, intr)
        r = proj - uv
        if z_obs is not None:
            has_z = (z_obs > 0).to(torch.float32)
            wz = intr.fx / torch.clamp(z_obs, min=0.5)
            r = torch.cat([r, ((p[:, 2] - z_obs) * wz * has_z)[:, None]], dim=1)
        rows = [torch.autograd.grad(r[:, c].sum(), (xi, dX), retain_graph=c + 1 < r.shape[1])
                for c in range(r.shape[1])]
    m = valid.to(torch.float32)
    Jc = torch.stack([gc for gc, _ in rows], dim=1)
    Jp = torch.stack([gp for _, gp in rows], dim=1)
    return r.detach() * m[:, None], Jc * m[:, None, None], Jp * m[:, None, None]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _schur_reduce(r, Jc, Jp, cam_idx, pnt_idx, K, Pn, damping):
    O = r.shape[0]
    dev = r.device
    Hp = _one_hot(pnt_idx, Pn).T
    Hc = _one_hot(cam_idx, K)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    V = (Hp @ torch.einsum("oij,oik->ojk", Jp, Jp).reshape(O, 9)).reshape(Pn, 3, 3)
    V = V + damping * eye3
    b_p = Hp @ torch.einsum("oij,oi->oj", Jp, r)
    Vinv = torch.linalg.inv_ex(V)[0]
    JcT_Jp = torch.einsum("oij,oik->ojk", Jc, Jp).reshape(O, 1, 18)
    G = (Hp @ (Hc[:, :, None] * JcT_Jp).reshape(O, K * 18)).reshape(Pn, K, 6, 3)
    Ud = (Hc.T @ torch.einsum("oij,oil->ojl", Jc, Jc).reshape(O, 36)).reshape(K, 6, 6)
    U = torch.zeros((K, 6, K, 6), dtype=torch.float32, device=dev)
    ar = torch.arange(K, device=dev)
    U[ar, :, ar, :] = Ud
    b_c = Hc.T @ torch.einsum("oij,oi->oj", Jc, r)
    GV = torch.einsum("pkjl,plm->pkjm", G, Vinv)
    GV_rows = GV.permute(1, 2, 0, 3).reshape(K * 6, Pn * 3)
    S_red = GV_rows @ G.permute(0, 3, 1, 2).reshape(Pn * 3, K * 6)
    S = U.reshape(K * 6, K * 6) - S_red
    b = b_c.reshape(K * 6) - GV_rows @ b_p.reshape(Pn * 3)
    return S, b, Vinv, b_p, G


def bundle_adjust(problem: BAProblem, intr: CameraIntrinsics, iters: int, damping: float,
                  fix_cameras: int, huber: float, pregate_px: float) -> torch.Tensor:
    """The refined window poses [K, 4, 4]."""
    K = problem.poses.shape[0]
    Pn = problem.points.shape[0]
    dev = problem.poses.device
    if pregate_px > 0:
        r0, _, _ = _ba_blocks(problem.poses, problem.points, problem.cam_idx, problem.pnt_idx,
                              problem.uv, problem.valid, intr, z_obs=problem.z)
        problem = problem._replace(valid=problem.valid & (torch.linalg.norm(r0, dim=-1) < pregate_px))
    eye = torch.eye(K * 6, dtype=torch.float32, device=dev)
    pin = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
    pin[: 6 * fix_cameras].fill_(1e6)
    poses, points = problem.poses, problem.points
    for _ in range(iters):
        r, Jc, Jp = _ba_blocks(poses, points, problem.cam_idx, problem.pnt_idx, problem.uv,
                               problem.valid, intr, z_obs=problem.z)
        if huber > 0:
            w = torch.sqrt(torch.clamp(huber / torch.clamp(torch.linalg.norm(r, dim=-1), min=1e-9),
                                       max=1.0))
            r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
        S, b, Vinv, b_p, G = _schur_reduce(r, Jc, Jp, problem.cam_idx, problem.pnt_idx, K, Pn,
                                           damping)
        S = S + damping * eye + torch.diag(pin)
        dx = torch.linalg.solve_ex(S, -b)[0].reshape(K, 6)
        poses_n = _apply_xi(poses, dx)
        Gt_dx = torch.einsum("pkjm,kj->pm", G, dx)
        points = points - torch.einsum("pij,pj->pi", Vinv, b_p + Gt_dx)
        poses = poses_n
    return poses


def local_ba(kps: List[sparse.Keypoints], poses: np.ndarray, intr: CameraIntrinsics,
             device) -> Optional[torch.Tensor]:
    """The window's refined poses from its keyframes' keypoints `kps` and
    poses `poses` [W, 4, 4] (the tracker's as it queued the solve), or None
    where the window has too few tracks to be solved."""
    W = len(kps)
    m_np = torch.stack([sparse.match(kps[i - 1], kps[i])[0] for i in range(1, W)]).cpu().numpy()
    uv_np = torch.stack([k.uv for k in kps]).cpu().numpy()
    d_np = torch.stack([k.depth for k in kps]).cpu().numpy()
    v_np = torch.stack([k.valid for k in kps]).cpu().numpy()
    m_np = m_np.astype(np.int64)
    v_np = v_np > 0.5
    poses = np.asarray(poses, np.float32)
    KP = uv_np.shape[1]
    P_CAP = KP
    uvs, deps, vals = list(uv_np), list(d_np), list(v_np)
    track_ids = [np.full(KP, -1, np.int32) for _ in range(W)]
    points = np.zeros((P_CAP, 3), np.float32)
    n_tracks = 0
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy
    for i in range(W - 1):
        m = m_np[i]
        fwd = (m >= 0) & vals[i] & vals[i + 1][np.maximum(m, 0)]
        has_id = fwd & (track_ids[i] >= 0)
        track_ids[i + 1][m[has_id]] = track_ids[i][has_id]
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
    if n_tracks < MIN_TRACKS:
        return None
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
        cam_idx[o: o + n] = i
        pnt_idx[o: o + n] = track_ids[i][sel]
        uv_obs[o: o + n] = uvs[i][sel]
        z_obs[o: o + n] = deps[i][sel]
        valid[o: o + n] = True
        o += n

    def t(x, dtype=None):
        x = torch.from_numpy(x).to(device)
        return x if dtype is None else x.to(dtype)

    problem = BAProblem(poses=t(poses), points=t(points), cam_idx=t(cam_idx),
                        pnt_idx=t(pnt_idx), uv=t(uv_obs), valid=t(valid), z=t(z_obs))
    return bundle_adjust(problem, intr, **OPTS)
