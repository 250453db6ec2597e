"""The per-frame SLAM step (port of `densemonoslam_tpu.step`).

One call runs, for one camera: preprocess, SO3 pre-align + coarse-to-fine
ICP+RGB tracking against the stored model prediction, the NID fuse gate, the
ACTIVE-window splat render, window fusion with the inline clean, fill-in and
insertion.  `SlamState` holds the same fields as the reference's, and the
stats vector keeps its 29-float layout.

Host reads: the reference decides `need_render` and `do_fuse` on the device
with `lax.cond`; here both come back to the host in ONE two-element read per
frame, and `odometry.track` makes one more read (the starvation flags).  No
other value of the step is read back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.mapping import fillin, fusion
from densemonoslam_tpu_torch.mapping import keyframe as kfmod
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import geometry, preprocess, splat
from densemonoslam_tpu_torch.tracking import odometry
from densemonoslam_tpu_torch.utils import se3
from densemonoslam_tpu_torch.utils.tensors import scalar


@dataclasses.dataclass
class SlamState:
    """Per-camera SLAM state, every field a tensor on the camera's device.
    Integer scalars are int64 here (int32 in the reference)."""

    map_data: torch.Tensor  # [N+1, 16]
    map_count: torch.Tensor  # []
    pose: torch.Tensor  # [4,4] camera-to-world
    tick: torch.Tensor  # []
    kf_pose: torch.Tensor  # [4,4]
    kf_intensity: torch.Tensor  # [H,W]
    kf_depth: torch.Tensor  # [H,W]
    kf_count: torch.Tensor  # [] keyframes so far (0 = none yet)
    # stored map prediction (last ACTIVE-mode render + fill-in), camera-frame
    # maps at `model_pose`; frames track against it until it is refreshed
    pred_intensity: torch.Tensor  # [H,W]
    pred_vmap: torch.Tensor  # [H,W,3]
    pred_nmap: torch.Tensor  # [H,W,3]
    pred_depth: torch.Tensor  # [H,W] (0 = hole)
    model_pose: torch.Tensor  # [4,4] render pose of the stored prediction
    model_rel: torch.Tensor  # [4,4] pose relative to model_pose
    model_age: torch.Tensor  # [] frames since refresh (big = invalid)
    consec_bad: torch.Tensor  # [] consecutive badly-tracked frames

    def replace(self, **kw) -> "SlamState":
        return dataclasses.replace(self, **kw)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SlamState))
_INT_FIELDS = ("map_count", "tick", "kf_count", "model_age", "consec_bad")

# stats vector layout (host-side decoding)
STAT_TRACK_OK = 0
STAT_ICP_ERR = 1
STAT_ICP_INL = 2
STAT_RGB_ERR = 3
STAT_NID = 4
STAT_FUSED = 5
STAT_MATCHED = 6
STAT_ADDED = 7
STAT_CULLED = 8
STAT_SURFELS = 9
STAT_KEYFRAMES = 10
STAT_CONSEC_BAD = 11
STAT_DROPPED = 12
N_STATS = 13
STAT_POSE0 = 13  # rows 13:29 carry the tracked pose, row-major 4x4
N_STATS_TOTAL = N_STATS + 16

MODEL_INVALID_AGE = 1 << 20  # marks the stored model as unusable


def init_state(
    capacity: int, height: int, width: int, device: torch.device | str = "cpu"
) -> SlamState:
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return SlamState(
        map_data=torch.zeros((capacity + 1, sm.COLS), **f32),
        map_count=torch.zeros((), **i64),
        pose=torch.eye(4, **f32),
        tick=torch.zeros((), **i64),
        kf_pose=torch.eye(4, **f32),
        kf_intensity=torch.zeros((height, width), **f32),
        kf_depth=torch.zeros((height, width), **f32),
        kf_count=torch.zeros((), **i64),
        pred_intensity=torch.zeros((height, width), **f32),
        pred_vmap=torch.zeros((height, width, 3), **f32),
        pred_nmap=torch.zeros((height, width, 3), **f32),
        pred_depth=torch.zeros((height, width), **f32),
        model_pose=torch.eye(4, **f32),
        model_rel=torch.eye(4, **f32),
        model_age=torch.full((), MODEL_INVALID_AGE, **i64),
        consec_bad=torch.zeros((), **i64),
    )


def state_from_numpy(d: Dict[str, np.ndarray], device: torch.device | str) -> SlamState:
    """Load a state from numpy arrays keyed by the `SlamState` field names
    (e.g. `np.asarray` of each field of the reference's `SlamState`)."""
    out = {}
    for name in STATE_FIELDS:
        dtype = torch.int64 if name in _INT_FIELDS else torch.float32
        out[name] = torch.from_numpy(np.array(d[name])).to(device=device, dtype=dtype)
    return SlamState(**out)


def state_to_numpy(state: SlamState) -> Dict[str, np.ndarray]:
    """Export a state as numpy arrays in the reference's dtypes (int32
    scalars, float32 tensors), keyed by field name."""
    out = {}
    for name in STATE_FIELDS:
        arr = getattr(state, name).detach().cpu().numpy()
        out[name] = arr.astype(np.int32 if name in _INT_FIELDS else np.float32)
    return out


def make_step(
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
    sensor: int = 0,
):
    """Build the per-frame step for a camera geometry + config.

    `step(state, rgb, depth_raw, in_pose, use_in_pose, weight_mult,
    cluster_id=0.0) -> (new_state, stats[29])`.  The map tensor of `state`
    is updated in place (the reference donates it)."""
    cfg = config
    if cfg.relocalisation:
        raise NotImplementedError("relocalisation (lost detection) is not ported yet")
    levels = cfg.pyramid_levels
    iterations = cfg.iterations_for_levels()
    pss = cfg.icp_weight_per_sensor
    icp_weight = pss[sensor] if pss is not None and sensor < len(pss) else cfg.icp_weight
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0
    # inlier support is normalised by the EFFECTIVE row count (`_gn_level`
    # strides rows only when the finest level keeps >= 4096 of them)
    stride_eff = (
        cfg.track_row_stride
        if (height * width) // (cfg.track_row_stride ** 2) >= 4096
        else 1
    )

    def step(
        state: SlamState,
        rgb: torch.Tensor,  # [H,W,3] u8/f32
        depth_raw: torch.Tensor,  # [H,W] raw units
        in_pose: torch.Tensor,  # [4,4] external pose (GT), identity if unused
        use_in_pose,  # [] bool (tensor or Python bool)
        weight_mult,  # [] f32
        cluster_id=0.0,
    ):
        dev = state.map_data.device
        use_in_pose = scalar(use_in_pose, torch.bool, dev)
        weight_mult = scalar(weight_mult, torch.float32, dev)
        t_now = state.tick
        # ---------------- preprocess ----------------------------------
        depth_track = preprocess.metricise_depth(
            depth_raw, cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff)
        )
        depth_m = torch.where(depth_track <= cfg.depth_cutoff, depth_track, 0.0)
        depth_f = preprocess.bilateral_filter_depth(depth_track)
        vmap_f = geometry.backproject(depth_m, intr)
        nmap_f = geometry.normal_map(vmap_f)
        if cfg.icl_nuim:
            nmap_f = -nmap_f
        intensity = preprocess.rgb_to_intensity(rgb)
        frame_pyr = odometry.build_frame_pyramid(rgb, depth_f, intr, levels)

        first = state.map_count == 0

        # ---------------- track against the stored prediction ----------
        model_pyr = odometry.build_model_pyramid(
            state.pred_intensity, state.pred_vmap, state.pred_nmap, levels
        )
        res = odometry.track(
            model_pyr, frame_pyr, state.model_rel, intr,
            iterations=iterations, icp_weight=icp_weight, rgb_only=cfg.rgb_only,
            pyramid=cfg.pyramid, use_so3=cfg.so3, row_stride=cfg.track_row_stride,
        )
        tracked_pose = state.model_pose @ res.A
        tracking_ok = ~res.failed & (state.model_age < MODEL_INVALID_AGE)
        new_pose = torch.where(first | ~tracking_ok, state.pose, tracked_pose)
        new_pose = torch.where(use_in_pose, in_pose, new_pose)
        ok = first | tracking_ok | use_in_pose
        model_cover = (state.pred_depth > 0).to(torch.float32).mean()
        # stays 0: counting badly tracked frames belongs to relocalisation
        consec_bad = torch.zeros_like(state.consec_bad)
        # velocity-based fusion weighting
        vel = torch.linalg.norm(new_pose[:3, 3] - state.pose[:3, 3])
        weight_mult = weight_mult * torch.clamp(1.0 - vel / 0.3, 0.25, 1.0)

        n_frame_valid = (frame_pyr.vmap[0][..., 2] > 0).to(torch.float32).sum() / float(
            stride_eff ** 2
        )
        support = res.icp_inliers / torch.clamp(n_frame_valid, min=1.0)

        # ---------------- NID fuse gate -------------------------------
        if cfg.nid_keyframing:
            n_img, n_depth, overlap = kfmod.nid_against_keyframe(
                kfmod.KeyFrame(pose=state.kf_pose, intensity=state.kf_intensity,
                               depth=state.kf_depth),
                intensity, vmap_f, new_pose, intr,
                depth_max=cfg.depth_cutoff, bins_img=cfg.nid_bins_img,
                bins_depth=cfg.nid_bins_depth, stride=cfg.nid_stride,
            )
            nid = kfmod.nid_score(n_img, n_depth, cfg.nid_depth_weight)
            # low tracking support forces fusion regardless of the NID score
            novel = (
                (nid > cfg.nid_threshold) | (overlap < 0.1) | (support < 0.75)
                | (model_cover < 0.5)
            )
            do_fuse = ok & (first | (state.kf_count == 0) | novel)
        else:
            nid = torch.zeros((), dtype=torch.float32, device=dev)
            do_fuse = ok

        # ---------------- render + fuse + clean (conditional) ----------
        d_pose = torch.where(
            use_in_pose,
            se3.se3_inverse(state.model_pose) @ new_pose,
            torch.where(tracking_ok & ~first, res.A, state.model_rel),
        )
        trans_delta = torch.linalg.norm(d_pose[:3, 3])
        rot_delta = torch.arccos(
            torch.clamp((torch.trace(d_pose[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        )
        need_render_t = (
            first | do_fuse
            | (support < cfg.model_min_support)
            | (trans_delta > cfg.model_trans_delta)
            | (rot_delta > cfg.model_rot_delta)
            | (state.model_age + 1 >= cfg.model_max_age)
        )
        # the step's one read of its own decisions
        need_render, fused = torch.stack([need_render_t, do_fuse]).tolist()

        data, count = state.map_data, state.map_count
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        matched = added = culled = dropped = zero
        if need_render:
            N_cap = data.shape[0] - 1
            win_n = win if 0 < win < N_cap else N_cap
            pred = splat.render(
                data, count, new_pose, intr, width, height, t_now,
                time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE, window=win,
            )
            pred_int, pred_v, pred_n, pred_d = pred.intensity, pred.vmap, pred.nmap, pred.depth
            if fused:
                win_start = splat.active_window_start(count, N_cap, win_n)
                S_pack = min(height * width, N_cap)
                blk, packed, rank, n_want, matched, culled = fusion.fuse_window(
                    splat.window_rows(data, win_start, win_n), win_start, count, pred,
                    vmap_f, nmap_f, rgb.to(torch.float32), new_pose, intr, time=t_now,
                    sensor=sensor, weight_mult=weight_mult, clean_depth=depth_m,
                    conf_threshold=cfg.confidence_threshold, time_delta=cfg.time_delta,
                    cluster_id=cluster_id, depth_gate_rel=cfg.depth_gate_rel,
                    # a map smaller than one frame must truncate: new rows first
                    pack_sorted=S_pack < height * width,
                )
                data, count, added, dropped = fusion.place_updates(
                    data, count, blk, win_start, packed[:S_pack], n_want, rank[:S_pack]
                )
                # the fused frame's content IS map content now: composite the
                # pre-fuse prediction with the live frame where it has holes
                comp = fillin.fill_in(
                    pred.intensity, pred.depth, pred.vmap, pred.nmap,
                    intensity, frame_pyr.vmap[0][..., 2], frame_pyr.vmap[0], frame_pyr.nmap[0],
                )
                pred_int, pred_v, pred_n, pred_d = comp.intensity, comp.vmap, comp.nmap, comp.depth
            model_pose, model_age = new_pose, zero
            model_rel = torch.eye(4, dtype=torch.float32, device=dev)
        else:
            pred_int, pred_v = state.pred_intensity, state.pred_vmap
            pred_n, pred_d = state.pred_nmap, state.pred_depth
            model_pose, model_age = state.model_pose, state.model_age + 1
            model_rel = d_pose

        if fused:
            # the NID keyframe snapshots the predicted composite
            kf_pose, kf_int = new_pose, pred_int
            kf_dep = torch.where(pred_d <= cfg.depth_cutoff, pred_d, 0.0)
        else:
            kf_pose, kf_int, kf_dep = state.kf_pose, state.kf_intensity, state.kf_depth
        kf_count = state.kf_count + int(fused)
        if cfg.frame_to_frame_rgb:
            pred_int = intensity

        new_state = SlamState(
            map_data=data, map_count=count, pose=new_pose, tick=t_now + 1,
            kf_pose=kf_pose, kf_intensity=kf_int, kf_depth=kf_dep, kf_count=kf_count,
            pred_intensity=pred_int, pred_vmap=pred_v, pred_nmap=pred_n, pred_depth=pred_d,
            model_pose=model_pose, model_rel=model_rel, model_age=model_age,
            consec_bad=consec_bad,
        )
        f = torch.float32
        stats = torch.cat([
            torch.stack([
                ok.to(f), res.icp_error, res.icp_inliers, res.rgb_error, nid,
                do_fuse.to(f), matched.to(f), added.to(f), culled.to(f), count.to(f),
                kf_count.to(f), consec_bad.to(f), dropped.to(f),
            ]),
            new_pose.reshape(-1),
        ])
        return new_state, stats

    return step
