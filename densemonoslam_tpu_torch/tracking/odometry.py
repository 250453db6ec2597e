"""Dense frame-to-model RGB-D odometry: SO(3) pre-alignment, then pyramidal
joint ICP + photometric Gauss-Newton (port of
`densemonoslam_tpu.tracking.odometry`).

Every loop runs to its static budget with a frozen carry (`torch.where`
keeps the old estimate once a level has converged), as in the reference
package, so the iterations themselves never read the device.

The one data-dependent branch is the starvation fallback of `_gn_level`
(redo a level with exact re-association when its first frozen iteration
starves): one `utils.graphs.branch` per level on the device flag, the
reference's `lax.cond` per level.

On the card each iteration is one launch of the fused kernel
(`ops.track_iter`: rows, Gram sums, solve and update), whose carry stays
in device memory from launch to launch; on the CPU the same iterations are
the plain op-by-op composition below (`reductions` rows, `gram`,
`solve_se3` / `solve_so3`, `_advance`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import geometry, preprocess, reductions, track_iter, warp
from densemonoslam_tpu_torch.utils import graphs, se3

ITERATIONS_DEFAULT = (4, 5, 10)
ITERATIONS_INTERMAP = (50, 50, 50)  # inter-map verification at a reduced size
SO3_ITERATIONS = 10
TRANSLATION_FAILURE_THRESH = 0.3  # metres
# intensity residuals are [0,255] units, ICP residuals metres
RGB_UNIT_SCALE = 1.0 / (255.0 * 255.0)


class FramePyramid(NamedTuple):
    """Per-level image data for one frame (index 0 = full resolution)."""

    intensity: Tuple[torch.Tensor, ...]
    vmap: Tuple[torch.Tensor, ...]
    nmap: Tuple[torch.Tensor, ...]
    grad_x: Tuple[torch.Tensor, ...]
    grad_y: Tuple[torch.Tensor, ...]


class ModelPyramid(NamedTuple):
    """Packed model tensors per level ([H, W, 12], `reductions.pack_model`)."""

    pack: Tuple[torch.Tensor, ...]


class TrackResult(NamedTuple):
    A: torch.Tensor  # [4,4] current-camera -> model-camera
    icp_error: torch.Tensor  # mean squared point-to-plane residual
    icp_inliers: torch.Tensor  # inlier count at the finest level
    rgb_error: torch.Tensor
    rgb_inliers: torch.Tensor
    JtJ: torch.Tensor  # [6,6] final combined system
    failed: torch.Tensor  # bool: update exceeded the translation guard


def model_pyramid_from_maps(intensity, vmap, nmap, grad_x, grad_y) -> ModelPyramid:
    return ModelPyramid(
        pack=tuple(
            reductions.pack_model(v, n, i, gx, gy)
            for v, n, i, gx, gy in zip(vmap, nmap, intensity, grad_x, grad_y)
        )
    )


def model_pyramid_from_frame(pyr: FramePyramid) -> ModelPyramid:
    """A live frame's pyramid as the tracking model (frame-to-frame mode)."""
    return model_pyramid_from_maps(pyr.intensity, pyr.vmap, pyr.nmap, pyr.grad_x, pyr.grad_y)


def build_model_pyramid(
    intensity: torch.Tensor, vmap0: torch.Tensor, nmap0: torch.Tensor, levels: int
) -> ModelPyramid:
    """Predicted model maps -> packed tracking pyramid; vertex/normal maps are
    decimated from the splat output."""
    ints = preprocess.build_pyramid(intensity, levels, depth=False)
    vmaps, nmaps = [], []
    vm, nm = vmap0, nmap0
    for _ in range(levels):
        vmaps.append(vm)
        nmaps.append(nm)
        vm, nm = warp.decimate(vm, 2), warp.decimate(nm, 2)
    grads = [preprocess.sobel_gradients(i) for i in ints]
    return model_pyramid_from_maps(
        ints, vmaps, nmaps, [g[0] for g in grads], [g[1] for g in grads]
    )


def build_frame_pyramid(
    rgb: torch.Tensor, depth_metric: torch.Tensor, intr: CameraIntrinsics, levels: int = 3
) -> FramePyramid:
    """rgb u8/f32 [H,W,3] + metric depth [H,W] -> FramePyramid."""
    return frame_pyramid_from_depth_intensity(
        preprocess.rgb_to_intensity(rgb), depth_metric, intr, levels
    )


def frame_pyramid_from_depth_intensity(
    intensity: torch.Tensor, depth_metric: torch.Tensor, intr: CameraIntrinsics, levels: int = 3
) -> FramePyramid:
    """Like `build_frame_pyramid`, from an intensity image already computed
    (decimated views for inter-map verification)."""
    intensity = preprocess.build_pyramid(intensity, levels, depth=False)
    depths = preprocess.build_pyramid(depth_metric, levels, depth=True)
    vmaps, nmaps, gxs, gys = [], [], [], []
    for lv in range(levels):
        vm = geometry.backproject(depths[lv], intr.scaled(lv))
        vmaps.append(vm)
        nmaps.append(geometry.normal_map(vm))
        gx, gy = preprocess.sobel_gradients(intensity[lv])
        gxs.append(gx)
        gys.append(gy)
    return FramePyramid(
        intensity=tuple(intensity), vmap=tuple(vmaps), nmap=tuple(nmaps),
        grad_x=tuple(gxs), grad_y=tuple(gys),
    )


def frame_pyramid_from_maps(
    intensity: torch.Tensor, vmap0: torch.Tensor, nmap0: torch.Tensor, levels: int
) -> FramePyramid:
    """A FramePyramid from rendered maps, for a prediction that plays the
    live frame (model-to-model loop-closure tracking); vertex/normal maps
    are decimated, not re-projected."""
    ints = preprocess.build_pyramid(intensity, levels, depth=False)
    vmaps, nmaps, gxs, gys = [], [], [], []
    vm, nm = vmap0, nmap0
    for lv in range(levels):
        vmaps.append(vm)
        nmaps.append(nm)
        gx, gy = preprocess.sobel_gradients(ints[lv])
        gxs.append(gx)
        gys.append(gy)
        vm, nm = warp.decimate(vm, 2), warp.decimate(nm, 2)
    return FramePyramid(
        intensity=tuple(ints), vmap=tuple(vmaps), nmap=tuple(nmaps),
        grad_x=tuple(gxs), grad_y=tuple(gys),
    )


def _so3_prealign(
    model: ModelPyramid, frame: FramePyramid, intr_top: CameraIntrinsics, R0: torch.Tensor
) -> torch.Tensor:
    """Rotation-only photometric alignment on the coarsest level with
    divergence rollback: 3 exact iterations, then Lucas-Kanade iterations
    against one sample frozen at the warmed-up rotation."""
    lv = len(frame.intensity) - 1
    i_c = frame.intensity[lv]
    pack_m = model.pack[lv]
    dev = i_c.device
    R_best = R0
    err_best = torch.full((), float("inf"), device=dev)
    R = R0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    exact = min(3, SO3_ITERATIONS)
    H, W = i_c.shape
    d = reductions.unit_rays(H, W, intr_top, dev)
    i_flat = i_c.reshape(H * W)
    smp = uv0 = None
    for k in range(SO3_ITERATIONS):
        if k == exact:
            rd0 = torch.sum(R * d[:, None, :], dim=-1)
            u0, v0, _ = geometry.project(rd0, intr_top)
            smp = reductions.sample_model(pack_m, u0, v0)
            uv0 = torch.stack([u0, v0], dim=-1)
        if k < exact:
            M = reductions.so3_rows_packed(i_c, pack_m, R, intr_top)
        else:
            M = reductions.so3_rows_frozen(d, i_flat, smp, uv0, R, intr_top)
        G = reductions.gram(M)
        err = G[3, 3] / torch.clamp(G[7, 7], min=1.0)
        dw = reductions.solve_so3(G[:3, :3], G[:3, 3], damping=reductions.SO3_DAMPING)
        ok = (G[7, 7] > reductions.SO3_MIN_INLIERS) & torch.all(torch.isfinite(dw))
        R_new = torch.where(ok, se3.so3_exp(dw) @ R, R)
        improved = err < err_best
        R_best_new = torch.where(improved, R, R_best)
        err_best_new = torch.minimum(err, err_best)
        R_next = torch.where(improved, R_new, R_best_new)  # diverged: roll back
        step_done = ~ok | (torch.sum(dw * dw) < reductions.SO3_STEP_TOL)
        R_best = torch.where(done, R_best, R_best_new)
        err_best = torch.where(done, err_best, err_best_new)
        R = torch.where(done, R, R_next)
        done = done | step_done
    return R


def _so3_prealign_fused(
    model: ModelPyramid, frame: FramePyramid, intr_top: CameraIntrinsics, A0: torch.Tensor
) -> torch.Tensor:
    """`_so3_prealign` on the card, one launch an iteration; returns A0
    with its rotation replaced (a view of the carry)."""
    lv = len(frame.intensity) - 1
    i_c, pack_m = frame.intensity[lv], model.pack[lv]
    dev = i_c.device
    carry = torch.empty(track_iter.SO3_CARRY, dtype=torch.float32, device=dev)
    sample = torch.empty(i_c.numel() * track_iter.SO3_SAMPLE, dtype=torch.float32, device=dev)
    src = A0.contiguous()
    exact = min(3, SO3_ITERATIONS)
    for k in range(SO3_ITERATIONS):
        track_iter.so3_iteration(
            i_c, pack_m, intr_top, src if k == 0 else carry, carry, fresh=k == 0,
            sample=sample if k >= exact else None, write_sample=k == exact,
        )
    return carry[track_iter.A].view(4, 4)


class _Level(NamedTuple):
    """Everything one pyramid level's GN iterations read."""

    v_c: torch.Tensor  # [h,w,3] (row-strided) frame vertices
    n_c: torch.Tensor
    i_c: torch.Tensor
    pack_m: torch.Tensor
    intr: CameraIntrinsics
    bilinear: bool
    icp_weight: float


def _solve_iter(lvl: _Level, M_icp, M_rgb):
    G_icp, G_rgb, JtJ, Jtr = reductions.combined_system(
        M_icp, M_rgb, icp_weight=lvl.icp_weight, rgb_scale=RGB_UNIT_SCALE
    )
    xi = reductions.solve_se3(JtJ, Jtr, damping=reductions.GN_DAMPING)
    enough = reductions.GN_MIN_INLIERS
    ok = torch.all(torch.isfinite(xi)) & ((G_icp.inliers > enough) | (G_rgb.inliers > enough))
    stats = (
        G_icp.residual_sq / torch.clamp(G_icp.inliers, min=1.0),
        G_icp.inliers,
        G_rgb.residual_sq / torch.clamp(G_rgb.inliers, min=1.0),
        G_rgb.inliers,
        JtJ,
    )
    return xi, ok, stats


def _advance(carry, xi, ok, stats_new):
    """One frozen-carry GN update: once `done`, later results are discarded."""
    A, stats, done = carry
    A_new = torch.where(ok, se3.apply_update(A, xi), A)
    step_done = ~ok | (torch.sum(xi * xi) < reductions.GN_STEP_TOL)
    A = torch.where(done, A, A_new)
    stats = tuple(torch.where(done, o, n) for o, n in zip(stats, stats_new))
    return (A, stats, done | step_done)


def _exact_iters(lvl: _Level, carry, n: int):
    """`n` iterations with exact re-association against the live sample."""
    for _ in range(n):
        M_icp, M_rgb = reductions.joint_rows_packed(
            lvl.v_c, lvl.n_c, lvl.i_c, lvl.pack_m, carry[0], lvl.intr, bilinear=lvl.bilinear
        )
        carry = _advance(carry, *_solve_iter(lvl, M_icp, M_rgb))
    return carry


def _frozen_iters(lvl: _Level, carry, n: int):
    """ONE model sample at the current estimate, then `n` Lucas-Kanade
    iterations against it.  Returns (carry, first_ok)."""
    P = lvl.i_c.numel()
    v_flat = lvl.v_c.reshape(P, 3)
    n_flat = lvl.n_c.reshape(P, 3)
    i_flat = lvl.i_c.reshape(P)
    p0 = se3.transform_points(carry[0], v_flat)
    u0, v0, _ = geometry.project(p0, lvl.intr)
    smp = reductions.sample_model(lvl.pack_m, u0, v0, bilinear=lvl.bilinear)
    uv0 = torch.stack([u0, v0], dim=-1)
    first_ok = None
    for k in range(n):
        M_icp, M_rgb = reductions.joint_rows_frozen(
            v_flat, n_flat, i_flat, smp, uv0, carry[0], lvl.intr
        )
        xi, ok, stats_new = _solve_iter(lvl, M_icp, M_rgb)
        if k == 0:
            first_ok = ok
        carry = _advance(carry, xi, ok, stats_new)
    return carry, first_ok


def _gn_level_fused(lvl: _Level, A0: torch.Tensor, level: int, iterations: int,
                    nearest_finest: bool, exact_iters: int):
    """`_gn_level`'s iterations on the card, one launch each, with the same
    schedule: exact, then frozen against one sample, the starvation
    fallback as a branch; or exact throughout.  Returns (A, stats), views
    of the level's carry.  `track` runs only levels with iterations."""
    if iterations < 1:
        raise ValueError(f"a fused level needs at least one iteration, got {iterations}")
    dev = A0.device
    carry = torch.empty(track_iter.GN_CARRY, dtype=torch.float32, device=dev)
    src = [A0.contiguous(), True]  # what the next launch starts from, and whether it is fresh

    def iterate(n, **kw):
        for _ in range(n):
            track_iter.gn_iteration(
                lvl.v_c, lvl.n_c, lvl.i_c, lvl.pack_m, lvl.intr, src[0], carry, fresh=src[1],
                bilinear=lvl.bilinear, icp_weight=lvl.icp_weight, rgb_scale=RGB_UNIT_SCALE, **kw,
            )
            src[:] = [carry, False]

    def result():
        return carry[track_iter.A].view(4, 4), (
            carry[track_iter.ICP_ERR], carry[track_iter.ICP_INL], carry[track_iter.RGB_ERR],
            carry[track_iter.RGB_INL], carry[track_iter.JTJ].view(6, 6),
        )

    if iterations > 12:
        # as `_gn_level`: `done` read every 10 iterations to stop early
        for start in range(0, iterations, 10):
            iterate(min(10, iterations - start))
            if bool(carry[track_iter.DONE]):
                break
        return result()
    ex = min(exact_iters, iterations) if nearest_finest else iterations
    iterate(ex)
    rest = iterations - ex
    if rest > 0:
        sample = torch.empty(lvl.i_c.numel() * track_iter.GN_SAMPLE, dtype=torch.float32,
                             device=dev)
        pre = torch.empty(track_iter.GN_CARRY, dtype=torch.float32, device=dev)
        starved = torch.empty((), dtype=torch.bool, device=dev)
        # the first frozen iteration samples the model, keeps the carry it
        # started from and flags starvation; the rest read the sample
        iterate(1, sample=sample, write_sample=True, pre=pre, starved=starved)
        iterate(rest - 1, sample=sample)

        def refit():
            src[:] = [pre, False]
            iterate(rest)

        graphs.branch(starved, refit, f"starved{level}")
    return result()


def _gn_level(
    model: ModelPyramid,
    frame: FramePyramid,
    A0: torch.Tensor,
    level: int,
    iterations: int,
    intr: CameraIntrinsics,
    icp_weight: float,
    rgb_only: bool,
    row_stride: int = 1,
    nearest_finest: bool = True,
    exact_iters: int = 0,
):
    """Gauss-Newton iterations at one pyramid level; returns (A, stats).

    When the first frozen iteration starves, the level is redone from its
    warm start with exact re-association (the branch `starved<level>`)."""
    i_c = frame.intensity[level]
    v_c, n_c = frame.vmap[level], frame.nmap[level]
    # subsample the residual rows where the level keeps a healthy row count
    if row_stride > 1 and i_c.numel() // (row_stride * row_stride) >= 4096:
        i_c = warp.decimate(i_c, row_stride)
        v_c = warp.decimate(v_c, row_stride)
        n_c = warp.decimate(n_c, row_stride)
    lvl = _Level(
        v_c=v_c, n_c=n_c, i_c=i_c, pack_m=model.pack[level], intr=intr.scaled(level),
        bilinear=not (nearest_finest and level <= 1),
        icp_weight=0.0 if rgb_only else icp_weight,
    )
    if A0.is_cuda:
        return _gn_level_fused(lvl, A0, level, iterations, nearest_finest, exact_iters)
    dev = A0.device
    inf = torch.full((), float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    carry = (A0, (inf, zero, inf, zero, torch.eye(6, device=dev)),
             torch.full((), iterations == 0, dtype=torch.bool, device=dev))
    if iterations > 12:
        # large budgets (inter-map verification, `ITERATIONS_INTERMAP`):
        # exact re-association until a step converges (the reference's
        # while-loop); the frozen carry makes more iterations change
        # nothing, so `done` is read every 10 iterations to stop early
        for start in range(0, iterations, 10):
            carry = _exact_iters(lvl, carry, min(10, iterations - start))
            if bool(carry[2]):
                break
        return carry[0], carry[1]
    if nearest_finest:
        ex = min(exact_iters, iterations)
        carry = _exact_iters(lvl, carry, ex)
        rest = iterations - ex
        if rest > 0:
            pre = carry
            carry, first_ok = _frozen_iters(lvl, carry, rest)
            starved = ~pre[2] & ~first_ok
            # the frozen carry's tensors are `torch.where` results of this
            # level alone: the fallback overwrites them in place
            out = (carry[0], *carry[1], carry[2])

            def refit():
                A, stats, done = _exact_iters(lvl, pre, rest)
                graphs.assign(out, (A, *stats, done))

            graphs.branch(starved, refit, f"starved{level}")
    else:
        carry = _exact_iters(lvl, carry, iterations)
    return carry[0], carry[1]


def track(
    model: ModelPyramid,
    frame: FramePyramid,
    A_init: torch.Tensor,
    intr: CameraIntrinsics,
    iterations: Tuple[int, ...] = ITERATIONS_DEFAULT,
    icp_weight: float = 10.0,
    rgb_only: bool = False,
    pyramid: bool = True,
    use_so3: bool = True,
    row_stride: int = 1,
    nearest_finest: bool = True,
    trans_fail_thresh: float = TRANSLATION_FAILURE_THRESH,
) -> TrackResult:
    """Full multi-level tracking; returns A with ``T_curr = T_model_view @ A``.

    Reads nothing back, apart from a level with more than 12 iterations,
    which reads its convergence flag every 10 iterations."""
    levels = len(frame.intensity)
    A = A_init
    if use_so3 and levels > 1:
        # warm-started from A_init's rotation, then replaces it
        if A.is_cuda:
            A = _so3_prealign_fused(model, frame, intr.scaled(levels - 1), A)
        else:
            R = _so3_prealign(model, frame, intr.scaled(levels - 1), A[:3, :3])
            A = A.clone()
            A[:3, :3] = R

    coarse_iters = sum(
        iterations[lv] for lv in range(1, min(levels, len(iterations))) if pyramid
    )
    nearest_eff = nearest_finest and coarse_iters > 0
    run = [
        lv for lv in range(levels - 1, -1, -1)
        if (iterations[lv] if lv < len(iterations) else 0) > 0 and (pyramid or lv == 0)
    ]
    stats = None
    for i, lv in enumerate(run):
        # the first GN level's warm start still carries the unsolved
        # translation, so it re-associates exactly for two iterations
        A, stats = _gn_level(
            model, frame, A, lv, iterations[lv], intr, icp_weight, rgb_only,
            row_stride=row_stride, nearest_finest=nearest_eff,
            exact_iters=2 if i == 0 else 0,
        )

    icp_err, icp_inl, rgb_err, rgb_inl, JtJ = stats
    dt = torch.linalg.norm(A[:3, 3] - A_init[:3, 3])
    failed = (dt > trans_fail_thresh) | ~torch.all(torch.isfinite(A))
    return TrackResult(
        A=torch.where(failed, A_init, A),
        icp_error=icp_err, icp_inliers=icp_inl, rgb_error=rgb_err, rgb_inliers=rgb_inl,
        JtJ=JtJ, failed=failed,
    )


def covariance(result: TrackResult) -> torch.Tensor:
    """Pose covariance, the inverse of the final combined JtJ; the loop and
    relocalisation acceptance gates read its diagonal."""
    eye = torch.eye(6, dtype=result.JtJ.dtype, device=result.JtJ.device)
    # `inv_ex`: `inv` checks for singularity on the host, a device sync
    return torch.linalg.inv_ex(result.JtJ + 1e-12 * eye).inverse
