"""Collective inter-map loop closures for collaborative sessions: one camera
per rank, each camera's map on its own rank (port of
`densemonoslam_tpu.parallel.intermap`).

Reference: `ReferenceFrame::resolveRelativeTransformationFern` finds another
map's fern keyframe that matches the current view and ICP-refines the
relative transform; `consumeReferenceFrame` then absorbs the other map.  A
round runs five stages on every rank of the mesh's `cam` group:

1. encode the current view and insert it in this camera's small fern
   keyframe DB if it is novel (`fern_insert`, evicting when full);
2. gather every camera's DB (one all-gather) and propose the best match
   among OTHER maps' keyframes; the proposals are gathered too;
3. serve: render this camera's map at the keyframe pose its lowest
   requester asked about, at a reduced resolution; the renders ride one
   all-gather;
4. verify: the requester aligns its live view onto the served render
   (`odometry.track`, `ITERATIONS_INTERMAP`) and gates on inliers, error
   and the pose covariance;
5. decide: the lowest accepted requester wins; every camera of the source
   map moves its map, poses and keyframe poses into the destination map's
   frame and takes its map id.

Every decision is computed from gathered tensors only, never from a rank's
own view, so every rank reaches the same one.  After a merge each camera
keeps its surfels on its own rank (a map sharded by camera).  With
`consume=True` the winner's rows are also broadcast from its rank and
appended to the target camera's map, and the winner's map and fern DB are
emptied (the reference's physical `consumeReferenceFrame`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.mapping import ferns as fernmod
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import reductions, splat, warp
from densemonoslam_tpu_torch.parallel import mesh as meshmod
from densemonoslam_tpu_torch.tracking import odometry
from densemonoslam_tpu_torch.utils import se3

FERN_K = 32  # keyframes per camera's DB
LEVELS = 3


class IntermapState(NamedTuple):
    """One camera's inter-map state."""

    codes: torch.Tensor  # [K, F] int32
    poses: torch.Tensor  # [K, 4, 4] keyframe poses (in this camera's map frame)
    times: torch.Tensor  # [K]
    count: torch.Tensor  # [] int64
    map_id: torch.Tensor  # [] int64: the map this camera lives in


def init_state(cam: int, num_ferns: int = 500, device: torch.device | str = "cuda") -> IntermapState:
    """Camera `cam`'s empty state; every camera starts in its own map."""
    return IntermapState(
        codes=torch.zeros((FERN_K, num_ferns), dtype=torch.int32, device=device),
        poses=torch.eye(4, dtype=torch.float32, device=device).expand(FERN_K, 4, 4).clone(),
        times=torch.full((FERN_K,), -1.0, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        map_id=torch.full((), cam, dtype=torch.int64, device=device),
    )


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`x[i]` for a 0-dim device index, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _mean_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fraction of the last axis on which `a` and `b` differ: the exact count
    scaled by f32(1/F), the rounding of the reference package's mean."""
    F = a.shape[-1]
    return (a != b).sum(dim=-1).to(torch.float32) * torch.full(
        (), 1.0 / F, dtype=torch.float32, device=a.device
    )


def fern_insert(
    ist: IntermapState,
    code: torch.Tensor,  # [F] int32
    pose: torch.Tensor,  # [4,4]
    t_now: torch.Tensor,  # [] f32
    fern_thresh: float,
) -> IntermapState:
    """Novelty-gated keyframe insert into one camera's DB; a full DB evicts
    its most redundant entry (the one nearest another stored entry) so the
    session keeps learning new places.  No host reads."""
    dev = code.device
    k = torch.arange(FERN_K, device=dev)
    stored = k < ist.count
    dis_own = torch.where(stored, _mean_differ(ist.codes, code[None]), 1.0)
    add = (dis_own.min() > fern_thresh) | (ist.count == 0)
    full = ist.count >= FERN_K
    pair = _mean_differ(ist.codes[:, None, :], ist.codes[None, :, :])  # [K, K]
    pair = torch.where(
        (k[:, None] != k[None, :]) & stored[:, None] & stored[None, :], pair, float("inf")
    )
    slot = torch.where(full, torch.argmin(pair.min(dim=1).values), ist.count)
    sel = (k == slot) & add
    return ist._replace(
        codes=torch.where(sel[:, None], code[None], ist.codes),
        poses=torch.where(sel[:, None, None], pose[None], ist.poses),
        times=torch.where(sel, t_now, ist.times),
        count=torch.clamp(ist.count + add.to(torch.int64), max=FERN_K),
    )


class MergeInfo(NamedTuple):
    """The round's outcome, the same on every rank."""

    merged: torch.Tensor  # [] bool: did a merge happen this round
    src_map: torch.Tensor  # [] int64
    dst_map: torch.Tensor  # [] int64
    requester: torch.Tensor  # [] int64
    target: torch.Tensor  # [] int64
    map_ids: torch.Tensor  # [n_cams] int64 post-round map ids
    T: torch.Tensor  # [n_cams, 4, 4] the transform each camera applied
    # per camera [n_cams, 4]: (proposing, inlier_frac, icp_error, best_dissim)
    stats: torch.Tensor
    dropped: torch.Tensor  # [] int64 rows lost to capacity in a consume append


def make_intermap_round(
    mesh: meshmod.Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: Optional[EngineConfig] = None,
    verify_scale: int = 4,
    fern_factor: int = 4,
    dissim_thresh: float = 0.35,
    min_inlier_frac: float = 0.5,
    icp_err_thresh: float = 5e-4,
    consume: bool = False,
):
    """`round_fn(state, ist, rgb, depth) -> (state, ist, MergeInfo)` for this
    rank's camera (see the module docstring).  `depth` is metric.  Four
    all-gathers over the `cam` group, and with `consume` a broadcast of the
    winner's rows and an all-reduce of the dropped count; host reads: the
    tracker's, and one of the round's decision."""
    cfg = config or EngineConfig()
    n = mesh.n_cams
    me = mesh.cam
    group = mesh.cam_group
    Hv, Wv = height // verify_scale, width // verify_scale
    intr_v = CameraIntrinsics(
        intr.fx / verify_scale, intr.fy / verify_scale,
        (intr.cx + 0.5) / verify_scale - 0.5, (intr.cy + 0.5) / verify_scale - 0.5,
    )
    hf, wf = height // fern_factor, width // fern_factor
    coders = {}

    def round_fn(state: stepmod.SlamState, ist: IntermapState, rgb, depth):
        dev = state.map_data.device
        f32 = dict(dtype=torch.float32, device=dev)
        if dev not in coders:
            coders[dev] = fernmod.make_coder(
                wf, hf, cfg.depth_cutoff, num_ferns=cfg.num_ferns, device=dev
            )
        rgb = torch.as_tensor(rgb, device=dev).to(torch.float32)
        depth = torch.as_tensor(depth, device=dev).to(torch.float32)
        F = ist.codes.shape[1]
        k = torch.arange(FERN_K, device=dev)

        # ---- 1. encode + novelty insert into my DB ------------------------
        code = fernmod.encode(
            coders[dev], fernmod.downsample_for_ferns(rgb, fern_factor),
            fernmod.downsample_for_ferns(depth, fern_factor),
        )
        ist = fern_insert(ist, code, state.pose, state.tick.to(torch.float32), cfg.fern_thresh)

        # ---- 2. propose against other maps' keyframes ---------------------
        # codes (4-bit), counts and map ids are exact in f32: one gather
        db = meshmod.all_gather(torch.cat([
            ist.codes.reshape(-1).to(torch.float32), ist.poses.reshape(-1),
            ist.count.to(torch.float32).reshape(1), ist.map_id.to(torch.float32).reshape(1),
        ]), group)
        codes_all = db[:, : FERN_K * F].reshape(n, FERN_K, F).to(torch.int32)
        poses_all = db[:, FERN_K * F : FERN_K * (F + 16)].reshape(n, FERN_K, 4, 4)
        counts_all = db[:, -2].to(torch.int64)
        mapid_all = db[:, -1].to(torch.int64)
        cam_ax = torch.arange(n, device=dev)
        eligible = (
            (cam_ax[:, None] != me) & (mapid_all[:, None] != ist.map_id)
            & (k[None, :] < counts_all[:, None])
        )
        diff = torch.where(eligible, _mean_differ(codes_all, code[None, None]), 1.0).reshape(-1)
        flat = torch.argmin(diff)
        tgt_cam, tgt_entry = flat // FERN_K, flat % FERN_K
        best_dis = _at(diff, flat)
        proposing = best_dis < dissim_thresh
        props = meshmod.all_gather(torch.stack([tgt_cam, tgt_entry, proposing.to(torch.int64)]), group)

        # ---- 3. serve: render my map at the pose my lowest requester asked
        asks_me = (props[:, 0] == me) & (props[:, 2] > 0)
        any_ask = asks_me.any()
        req_id = torch.argmax(asks_me.to(torch.int64))  # the first (lowest) requester
        pose_req = _at(ist.poses, _at(props, req_id)[1])
        pred = splat.render(
            state.map_data, state.map_count, pose_req, intr_v, Wv, Hv, state.tick,
            time_delta=cfg.time_delta, mode=splat.MODE_ALL, depth_max=cfg.max_depth,
        )
        pack = torch.cat(
            [pred.intensity[..., None], pred.vmap, pred.nmap, pred.depth[..., None]], dim=-1
        )  # [Hv, Wv, 8]; the served flag and requester ride along
        served = torch.stack([any_ask.to(torch.float32), req_id.to(torch.float32)])
        gathered = meshmod.all_gather(torch.cat([pack.reshape(-1), served]), group)

        # ---- 4. verify: align my live view onto the target's render -------
        mine = _at(gathered, tgt_cam)
        srv = mine[:-2].reshape(Hv, Wv, 8)
        model = odometry.build_model_pyramid(srv[..., 0], srv[..., 1:4], srv[..., 4:7], LEVELS)
        d_v = warp.decimate(depth, verify_scale)
        i_v = warp.decimate(
            0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2], verify_scale
        )
        frame = odometry.frame_pyramid_from_depth_intensity(i_v, d_v, intr_v, LEVELS)
        res = odometry.track(
            model, frame, torch.eye(4, **f32), intr_v,
            iterations=odometry.ITERATIONS_INTERMAP, icp_weight=cfg.icp_weight, use_so3=True,
            # inter-map baselines legitimately exceed the frame-to-model
            # guard; the inlier/error/covariance gates carry the rejection
            trans_fail_thresh=2.0,
        )
        n_valid = (d_v > 0).to(torch.float32).sum()
        inlier_frac = res.icp_inliers / torch.clamp(n_valid, min=1.0)
        # my request was served iff my target chose me (one requester each)
        was_served = proposing & (mine[-2] > 0) & (mine[-1] == me)
        cov_ok = torch.all(reductions.diag_inv_6x6(res.JtJ) < cfg.cov_thresh)
        ok = (
            was_served & ~res.failed & (inlier_frac >= min_inlier_frac)
            & (res.icp_error <= icp_err_thresh) & cov_ok
        )
        # A maps my camera frame to the target keyframe's, so my map goes to
        # the target's map by T = pose_kf @ A @ inv(my pose)
        pose_kf = _at(_at(poses_all, tgt_cam), tgt_entry)
        T_ab = pose_kf @ res.A @ se3.se3_inverse(state.pose)

        # ---- 5. replicated decision + apply ------------------------------
        out = meshmod.all_gather(torch.cat([
            ok.to(torch.float32).reshape(1), T_ab.reshape(-1),
            torch.stack([proposing.to(torch.float32), inlier_frac, res.icp_error, best_dis]),
        ]), group)
        oks, Ts, stats = out[:, 0] > 0, out[:, 1:17].reshape(n, 4, 4), out[:, 17:]
        tgts = props[:, 0]
        any_merge = oks.any()
        winner = torch.argmax(oks.to(torch.int64))  # the lowest accepted requester
        target = _at(tgts, winner)
        src_map, dst_map = _at(mapid_all, winner), _at(mapid_all, target)
        T_win = _at(Ts, winner)
        moves = any_merge & (mapid_all == src_map)  # [n] cameras in the source map
        eye = torch.eye(4, **f32).expand(n, 4, 4)
        info = MergeInfo(
            merged=any_merge, src_map=src_map, dst_map=dst_map, requester=winner,
            target=target, map_ids=torch.where(moves, dst_map, mapid_all),
            T=torch.where(moves[:, None, None], T_win, eye), stats=stats,
            dropped=torch.zeros((), dtype=torch.int64, device=dev),
        )
        # the round's one read: every value in it comes from gathered tensors
        merged, in_src, w, t = torch.stack(
            [any_merge.to(torch.int64), moves[me].to(torch.int64), winner, target]
        ).tolist()
        if in_src:
            R, t_vec = T_win[:3, :3], T_win[:3, 3]
            data = state.map_data
            alive = (data[:-1, sm.CONF] > 0)[:, None]
            data[:-1, sm.POS] = torch.where(alive, data[:-1, sm.POS] @ R.T + t_vec, data[:-1, sm.POS])
            data[:-1, sm.NORMAL] = torch.where(alive, data[:-1, sm.NORMAL] @ R.T, data[:-1, sm.NORMAL])
            state = state.replace(
                pose=T_win @ state.pose, kf_pose=T_win @ state.kf_pose,
                model_age=torch.full_like(state.model_age, stepmod.MODEL_INVALID_AGE),
            )
            ist = ist._replace(
                map_id=dst_map.clone(), poses=torch.einsum("ij,kjl->kil", T_win, ist.poses)
            )
        if consume and merged:
            # the physical consumeReferenceFrame: the winner's rows go to its
            # target; the winner's map and fern DB empty
            routed = state.map_data[:-1].clone() if me == w else torch.empty_like(state.map_data[:-1])
            meshmod.broadcast(routed, w, group)
            dropped = torch.zeros((), dtype=torch.int64, device=dev)
            if me == t:
                m = sm.SurfelMap(data=state.map_data, count=state.map_count)
                valid = routed[:, sm.CONF] > 0
                room = torch.clamp(m.capacity - m.count, min=0)
                dropped = torch.clamp(valid.sum() - room, min=0)
                m = sm.append_surfels(m, routed, valid)
                state = state.replace(map_data=m.data, map_count=m.count)
            elif me == w:
                state = state.replace(
                    map_data=torch.zeros_like(state.map_data),
                    map_count=torch.zeros_like(state.map_count),
                )
                fresh = init_state(0, F, dev)
                ist = fresh._replace(map_id=ist.map_id)
            info = info._replace(dropped=meshmod.all_reduce_sum(dropped, group))
        return state, ist, info

    return round_fn
