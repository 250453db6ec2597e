"""The per-frame SLAM step (port of `densemonoslam_tpu.step`).

One call runs, for one camera: preprocess, SO3 pre-align + coarse-to-fine
ICP+RGB tracking against the stored model prediction, the NID fuse gate, the
ACTIVE-window splat render, window fusion with the inline clean, fill-in and
insertion.  `SlamState` holds the same fields as the reference's, and the
stats vector keeps its 29-float layout.

The step is one device program, as the reference's jitted step is.  Its
decisions stay on the device: the render branch (render, fuse, place,
fill-in) and the fuse branch inside it are `utils.graphs.branch`es, as are
the starved-level fallbacks of `odometry.track`; everything else is a
device select.  Nothing is read back.  `make_graphed_step` captures the
step as one CUDA graph, each branch a conditional IF node, and replays it
every frame, the map updated in place (the reference donates it).
`make_step` returns the same step to run op by op: on the CPU, where each
branch is a Python `if` whose read of its predicate is the step's only
host read, and on the card where a caller wants it uncaptured.

The step stamps its stages (`utils.timer.StageRing`, the step's
`stages`): at its start, after tracking, at the render branch's start and
end, at the fuse branch's start and end, and at its end, each stamp keyed
by the frame's tick.  On the card a stamp is a one-thread kernel, captured
into the graph and its IF bodies like any other, so every replay times its
own stages; on the CPU it is the host's clock.  `stage_ms` turns a ring
into per-frame stage times; `Engine.stage_ms` reads a camera's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.mapping import fillin, fusion
from densemonoslam_tpu_torch.mapping import keyframe as kfmod
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import geometry, preprocess, reductions, splat
from densemonoslam_tpu_torch.tracking import odometry
from densemonoslam_tpu_torch.utils import graphs, se3, timer
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

# the step's stage stamps, in the order a frame that fuses takes them
STAGES = ("start", "tracked", "render_start", "fuse_start", "fuse_end", "render_end", "end")
(_START, _TRACKED, _RENDER_START, _FUSE_START, _FUSE_END, _RENDER_END,
 _END) = range(len(STAGES))


def init_state(
    capacity: int, height: int, width: int, device: torch.device | str = "cuda"
) -> SlamState:
    """An empty state on `device` (the card unless the caller says otherwise)."""
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
    is updated in place (the reference donates it).  `step.stages` is the
    ring its stage stamps go to."""
    cfg = config
    stages = timer.StageRing(len(STAGES))
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
        stages.stamp(_START, t_now)
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
        stages.stamp(_TRACKED, t_now)
        tracked_pose = state.model_pose @ res.A
        tracking_ok = ~res.failed & (state.model_age < MODEL_INVALID_AGE)
        new_pose = torch.where(first | ~tracking_ok, state.pose, tracked_pose)
        new_pose = torch.where(use_in_pose, in_pose, new_pose)
        ok = first | tracking_ok | use_in_pose
        model_cover = (state.pred_depth > 0).to(torch.float32).mean()
        if cfg.relocalisation:
            # lost detection: ICP error and every pose-covariance diagonal
            # under 1e-4, and the map visible in the view; more than 10
            # consecutive bad frames => lost.  The counter stays on the
            # device; the engine polls it at the loop-check cadence.
            cov_d = reductions.diag_inv_6x6(res.JtJ)
            bad = (
                (~tracking_ok | (res.icp_error > 1e-4) | torch.any(cov_d > 1e-4)
                 | (model_cover < 0.1))
                & ~first & ~use_in_pose
            )
            consec_bad = torch.where(bad, state.consec_bad + 1, 0)
            lost = consec_bad > 10
        else:
            consec_bad = torch.zeros_like(state.consec_bad)
            lost = torch.zeros((), dtype=torch.bool, device=dev)
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
        # a lost camera must not corrupt the map; in relocalisation mode
        # fusion also needs the model visible in the tracked frame, or a
        # teleported camera would fuse a phantom copy of the scene
        do_fuse = do_fuse & ~lost
        if cfg.relocalisation:
            do_fuse = do_fuse & ((model_cover >= 0.1) | first)

        # ---------------- render + fuse + clean (device branches) ------
        d_pose = torch.where(
            use_in_pose,
            se3.se3_inverse(state.model_pose) @ new_pose,
            torch.where(tracking_ok & ~first, res.A, state.model_rel),
        )
        trans_delta = torch.linalg.norm(d_pose[:3, 3])
        rot_delta = torch.arccos(
            torch.clamp((torch.trace(d_pose[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        )
        need_render = (
            first | do_fuse
            | (support < cfg.model_min_support)
            | (trans_delta > cfg.model_trans_delta)
            | (rot_delta > cfg.model_rot_delta)
            | (state.model_age + 1 >= cfg.model_max_age)
        )
        data, count = state.map_data, state.map_count
        N_cap = data.shape[0] - 1  # shape-derived: callers may size the map
        win_n = win if 0 < win < N_cap else N_cap
        S_pack = min(height * width, N_cap)
        # the render branch's outputs, holding what the keep side returns:
        # the branch overwrites them where it runs (only window-sized
        # blocks and images pass out; the map is written in place)
        pred_int = state.pred_intensity.clone()
        pred_v = state.pred_vmap.clone()
        pred_n = state.pred_nmap.clone()
        pred_d = state.pred_depth.clone()
        model_pose = state.model_pose.clone()
        model_age = state.model_age + 1
        new_count = count.clone()
        matched, added, culled, dropped = (
            torch.zeros((), dtype=torch.int64, device=dev) for _ in range(4)
        )

        def render_branch():
            stages.stamp(_RENDER_START, t_now)
            pred = splat.render(
                data, count, new_pose, intr, width, height, t_now,
                time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE, window=win,
            )
            graphs.assign((pred_int, pred_v, pred_n, pred_d, model_pose),
                          (pred.intensity, pred.vmap, pred.nmap, pred.depth, new_pose))
            model_age.zero_()

            def fuse_branch():
                stages.stamp(_FUSE_START, t_now)
                win_start = splat.active_window_start(count, N_cap, win_n)
                blk, packed, rank, n_want, n_matched, n_culled = fusion.fuse_window(
                    splat.window_rows(data, win_start, win_n), win_start, count, pred,
                    vmap_f, nmap_f, rgb.to(torch.float32), new_pose, intr, time=t_now,
                    sensor=sensor, weight_mult=weight_mult, clean_depth=depth_m,
                    conf_threshold=cfg.confidence_threshold, time_delta=cfg.time_delta,
                    cluster_id=cluster_id, depth_gate_rel=cfg.depth_gate_rel,
                    # a map smaller than one frame must truncate: new rows first
                    pack_sorted=S_pack < height * width,
                )
                _, n_after, n_added, n_dropped = fusion.place_updates(
                    data, count, blk, win_start, packed[:S_pack], n_want, rank[:S_pack]
                )
                i64 = torch.int64
                graphs.assign(
                    (new_count, matched, added, culled, dropped),
                    (n_after.to(i64), n_matched.to(i64), n_added.to(i64),
                     n_culled.to(i64), n_dropped.to(i64)),
                )
                # the fused frame's content IS map content now: composite the
                # pre-fuse prediction with the live frame where it has holes
                comp = fillin.fill_in(
                    pred.intensity, pred.depth, pred.vmap, pred.nmap,
                    intensity, frame_pyr.vmap[0][..., 2], frame_pyr.vmap[0], frame_pyr.nmap[0],
                )
                graphs.assign((pred_int, pred_v, pred_n, pred_d),
                              (comp.intensity, comp.vmap, comp.nmap, comp.depth))
                stages.stamp(_FUSE_END, t_now)

            graphs.branch(do_fuse, fuse_branch, "fuse")
            stages.stamp(_RENDER_END, t_now)

        graphs.branch(need_render, render_branch, "render")
        model_rel = torch.where(
            need_render, torch.eye(4, dtype=torch.float32, device=dev), d_pose
        )
        # keyframe promotion on fuse: the NID keyframe snapshots the
        # predicted composite
        kf_pose = torch.where(do_fuse, new_pose, state.kf_pose)
        kf_int = torch.where(do_fuse, pred_int, state.kf_intensity)
        kf_dep = torch.where(
            do_fuse, torch.where(pred_d <= cfg.depth_cutoff, pred_d, 0.0), state.kf_depth
        )
        kf_count = state.kf_count + do_fuse.to(state.kf_count.dtype)
        count = new_count
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
        stages.stamp(_END, t_now)
        return new_state, stats

    step.stages = stages
    return step


def stage_ms(stages: Optional[timer.StageRing]) -> Dict[str, List[Tuple[int, float]]]:
    """Per-frame milliseconds of the step's stages from its stamp ring (one
    copy to the host): ``track`` (start to after tracking: preprocess,
    pyramids, ICP+RGB), ``render`` (the render branch less the fuse branch
    inside it, frames that rendered), ``fuse`` (the fuse branch: window
    fusion, placement and fill-in, frames that fused) and ``step`` (start
    to end), each a list of (tick, ms) by tick."""
    stamps = None if stages is None else stages.read()
    if stamps is None:
        return {"track": [], "render": [], "fuse": [], "step": []}
    fuse = stages.intervals(_FUSE_START, _FUSE_END, stamps)
    inner = dict(fuse)
    return {
        "track": stages.intervals(_START, _TRACKED, stamps),
        "render": [(k, ms - inner.get(k, 0.0))
                   for k, ms in stages.intervals(_RENDER_START, _RENDER_END, stamps)],
        "fuse": fuse,
        "step": stages.intervals(_START, _END, stamps),
    }


def make_graphed_step(
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
    sensor: int = 0,
):
    """`make_step`'s step as one CUDA graph (the reference's
    `jax.jit(step, donate_argnums=(0,))`), for CUDA tensors.

    The same call and results as the eager step.  It is captured at its
    first call: the state it was given becomes the graph's state, taken by
    address (the map too) and updated in place by every replay, and the
    returned state holds those same tensors; a field replaced from outside
    is copied in at the next call (`graphs.STATE_COPIES`).  The stats
    vector lives in the graph's pool: the next replay overwrites it, so a
    caller clones what it keeps.  A CPU tensor raises `ValueError`."""
    eager = make_step(intr, height, width, config, sensor)
    n = len(STATE_FIELDS)
    tick = STATE_FIELDS.index("tick")

    def program(*flat):
        state = SlamState(*flat[:n])
        new_state, stats = eager(state, *flat[n:])
        for name in STATE_FIELDS:
            old, new = getattr(state, name), getattr(new_state, name)
            if new is not old:
                old.copy_(new)
        return stats

    # the session tick is written anew every frame: an input, not state
    graphed = graphs.GraphedFn(program, donate=[i for i in range(n) if i != tick])

    def step(state, rgb, depth_raw, in_pose, use_in_pose, weight_mult, cluster_id=0.0):
        if graphed.graph is None:
            # the stamp ring outside the graph's pool, before its capture
            eager.stages.allocate(state.tick.device)
        stats = graphed(*(getattr(state, f) for f in STATE_FIELDS), rgb, depth_raw, in_pose,
                        use_in_pose, weight_mult, cluster_id)
        return SlamState(*graphed.inputs[:n]), stats

    step.graphed = graphed
    step.stages = eager.stages
    return step


def make_device_step(
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
    sensor: int,
    device: torch.device | str,
):
    """The step as it runs on `device`: `make_graphed_step`'s on the card,
    `make_step`'s elsewhere."""
    make = make_graphed_step if torch.device(device).type == "cuda" else make_step
    return make(intr, height, width, config, sensor)
