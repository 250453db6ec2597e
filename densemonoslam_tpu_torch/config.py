"""Configuration objects for the engine (numpy-only copy of
`densemonoslam_tpu.config`; a test holds every default equal to it).

Replaces the reference's process-wide singletons (`Resolution::getInstance`,
`Intrinsics::getInstance`, `Core/src/Utils/{Resolution,Intrinsics}.h`) and the
boost::program_options `Options` singleton (`Core/src/Utils/Options.h:83-359`,
flag list in reference `README.md:56-126`) with explicit dataclasses passed to
the engine.  Defaults mirror the reference's defaults so behaviour parity can
be checked flag-by-flag; names are spelled out instead of the reference's
two-letter CLI mnemonics (`--t`, `--ic`, `--ie`, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrameResolution:
    """Image size processed by the engine (reference `Resolution.h` singleton).

    Reference operating points: 1024x320 for KITTI/ECMR'21
    (`GUI/src/MainController.cpp:39`), 640x480 for TUM/ICL
    (`GPUTest/src/GPUTest.cpp:163`).
    """

    width: int = 640
    height: int = 480

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def pyramid(self, levels: int) -> Tuple["FrameResolution", ...]:
        """Resolutions of a power-of-two pyramid, level 0 = full size."""
        return tuple(
            FrameResolution(self.width >> i, self.height >> i) for i in range(levels)
        )


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics (reference `Intrinsics.h` singleton; calibration file
    is one line "fx fy cx cy", `GUI/src/MainController.cpp:171-188`)."""

    fx: float
    fy: float
    cx: float
    cy: float

    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def scaled(self, level: int) -> "CameraIntrinsics":
        """Intrinsics for pyramid level `level` (each level halves the image).

        Matches the reference's per-level `K(i)` used by the trackers
        (`Core/src/Utils/RGBDOdometry.cpp` pyramid setup).
        """
        s = 1.0 / (1 << level)
        return CameraIntrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)

    @staticmethod
    def default_for(res: FrameResolution) -> "CameraIntrinsics":
        """Reference fallback when no calibration is given: fx=fy=528-style
        Kinect defaults scaled to the resolution (EF convention)."""
        return CameraIntrinsics(
            fx=528.0 * res.width / 640.0,
            fy=528.0 * res.height / 480.0,
            cx=res.width / 2.0 - 0.5,
            cy=res.height / 2.0 - 0.5,
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine behaviour flags.  Source of every default: the reference
    `Options.h:83-100` defaults and `README.md:56-126` flag docs.
    """

    # --- time-windowed active/inactive map (`--t`) -------------------------
    time_delta: int = 200  # ticks; surfels older than this are "inactive"

    # --- loop-closure acceptance gates ------------------------------------
    icp_count_thresh: int = 35000  # `--ic` inlier count gate
    icp_err_thresh: float = 5e-5  # `--ie` ICP error gate
    cov_thresh: float = 1e-4  # covariance-diagonal gate on loop/reloc
    # acceptance (reference uses 1e-4 in the reloc ok-test,
    # `ElasticFusion.cpp:204-244`, 8e-5 in the local-loop gate :427-442;
    # measured good tracks here sit at ~1e-5, wrong-place matches at ~3e-3)
    photo_thresh: float = 115.0  # `--pt` fern photometric consistency gate
    fern_thresh: float = 0.3095  # `--ft` fern dissimilarity keep threshold

    # --- map / fusion ------------------------------------------------------
    confidence_threshold: float = 10.0  # `--c` surfel stable-confidence gate
    depth_cutoff: float = 3.0  # `--d` metres; fusion ignores deeper pixels
    # fusion association / free-space gates proportional to depth (fraction
    # of z).  0 keeps the reference's absolute gates (+-0.05 m window,
    # data.vert) — correct at indoor scale; street/KITTI-scale depth (tens of
    # metres, predicted by a CNN with ~5-8% error) needs gates that grow with
    # range or every refused association duplicates the scene every frame
    depth_gate_rel: float = 0.0
    max_depth: float = 25.0  # tracking depth cutoff (reference
    # maxDepthProcessed = 25 m, `ElasticFusion.cpp:56` — the dense tracker
    # sees far geometry the fusion cutoff excludes)
    icp_weight: float = 10.0  # `--i` ICP weight vs RGB in joint GN
    # per-sensor tracking weights (`--ipt`, reference Options.h icpPerSensor:
    # mixed-sensor collaborative sessions weight ICP differently per camera);
    # indexed by sensor id, None / missing index falls back to `icp_weight`
    icp_weight_per_sensor: Optional[Tuple[float, ...]] = None

    # --- NID keyframing (`--nid`, `--ndw`, `--nbi`, `--nbd`, `--nkf`) ------
    nid_threshold: float = 0.85
    nid_depth_weight: float = 0.7
    nid_bins_img: int = 64
    nid_bins_depth: int = 500
    nid_keyframing: bool = True  # `--nkf` disables when False
    nid_stride: int = 4  # NID histograms on stride-decimated frames (the
    # reference's optional pyramid-down; histogram statistics are insensitive
    # and the warp gather is the NID gate's dominant cost)

    # --- deformation graph -------------------------------------------------
    deform_graph_sample_rate: int = 5000  # `--dgs` 1 node per N surfels
    max_deform_nodes: int = 512  # reference buffer cap is 2048 (Deformation.cpp:27)
    # local (time-window) loop closure (`ElasticFusion.cpp:399-495`)
    loop_check_interval: int = 8  # attempt a local loop every N frames
    loop_min_inactive_frac: float = 0.12  # inactive prediction coverage needed
    loop_inlier_frac: float = 0.35  # of valid pixels (reference icpCountThresh)
    loop_icp_err_thresh: float = 5e-4  # reference: err < 3e-4 (their units)
    loop_cons_err_thresh: float = 0.01  # accept deformation when mean cons err below
    loop_constraint_stride: int = 20  # constraint sampling grid (reference /20)

    # --- tracker mode flags ------------------------------------------------
    open_loop: bool = False  # `--o` disable deformation/loops
    rgb_only: bool = False  # `--rgb` photometric-only tracking
    pyramid: bool = True  # `--np` disables coarse-to-fine when False
    fast_odom: bool = False  # `--fo` single-level {3,0,0} iterations
    so3: bool = True  # `--nso` disables SO(3) pre-alignment when False
    frame_to_frame_rgb: bool = False  # `--ftf`
    relocalisation: bool = False  # `--rl` tracking-loss detection + fern reloc
    icl_nuim: bool = False  # `--icl` flip normals (synthetic data convention)

    # --- sparse/hybrid tracking -------------------------------------------
    orb_tracking: bool = False  # `--orb_tracking` pose from sparse tracker
    hybrid_loops: bool = False  # `--hybrid_loops` sparse loop pairs drive global deforms
    predict_depth: bool = False  # `--predict_depth` monocular depth CNN

    # --- ferns -------------------------------------------------------------
    num_ferns: int = 500  # `--n` fern tests per frame
    fern_pyr_level: int = 3  # ferns operate on 2^level-downsampled frames
    fern_db_capacity: int = 512  # initial keyframe DB capacity; grows
    # geometrically up to `fern_db_max` (the reference's frame vector is
    # unbounded, `Ferns.h:76-89`)
    fern_db_max: int = 4096

    # --- capacity ----------------------------------------------------------
    max_surfels: int = 1 << 21  # reference: 5700^2 ~= 32.5M (GlobalModel.cpp:22-24)
    max_sensors: int = 3  # MAX_SENSORS/NUM_CAMERAS (Shaders/size.glsl)
    # active tail-block size for the hot ACTIVE-mode passes (render for
    # tracking, fusion, clean): per-frame cost scales with this, not with
    # max_surfels.  Must comfortably exceed the surfels visible in one view
    # (<= H*W) plus the time-window working set; compaction keeps the layout
    # [inactive..., active...] so the block is a superset of the ACTIVE set.
    active_window: int = 1 << 19

    # --- misc --------------------------------------------------------------
    fusion_weight_multiplier: float = 1.0  # per-frame weight scale (velocity-based)
    depth_factor: float = 1000.0  # raw uint16 depth units per metre
    pyramid_levels: int = 3  # reference uses 3 at 640x480; use 4 at VGA+ for
    # larger inter-frame motion (coarsest level should be <= ~100 px wide)
    track_row_stride: int = 1  # finest-level residual-row subsampling (2 at
    # VGA+ quarters the dominant per-frame gather cost at negligible ATE cost)
    # stored-tracking-model refresh gates: the map is re-rendered (and the
    # fill-in tracking model rebuilt) when fusing, when tracking SUPPORT
    # (ICP inliers / valid frame pixels) decays below `model_min_support`,
    # when the camera moved this far from the model's render pose, or when
    # the model is this many frames old — between refreshes, frames track
    # against the stored model with a warm-started GN, skipping the
    # per-frame map render (and its scatter-min z-buffer, the single most
    # expensive device op) entirely.  Support is the primary gate: it
    # measures exactly the quantity that degrades as the view slides off
    # the stored prediction, so the motion thresholds are a coarse backstop
    # for teleports rather than the steady-state trigger.
    model_min_support: float = 0.7  # ICP inlier fraction of valid pixels
    model_trans_delta: float = 0.25  # metres
    model_rot_delta: float = 0.2  # radians (~11 deg)
    model_max_age: int = 16  # frames

    def iterations_for_levels(self) -> Tuple[int, ...]:
        """Per-level GN iteration budget, finest-first (reference
        `RGBDOdometry.cpp:387-389`: {10,5,4}; fast mode {3,0,0})."""
        if self.fast_odom:
            base = (3,) + (0,) * (self.pyramid_levels - 1)
        else:
            base = (4, 5, 10, 10, 10)
        return tuple(base[: self.pyramid_levels])

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Bundle of what the reference configures once per process but we carry
    per camera stream (collaborative sessions may mix sensors)."""

    resolution: FrameResolution
    intrinsics: CameraIntrinsics
    name: str = "cam0"

    @staticmethod
    def tum_default(name: str = "cam0") -> "CameraConfig":
        res = FrameResolution(640, 480)
        return CameraConfig(res, CameraIntrinsics(528.0, 528.0, 320.0, 240.0), name)

    @staticmethod
    def kitti_default(name: str = "cam0") -> "CameraConfig":
        res = FrameResolution(1024, 320)
        return CameraConfig(res, CameraIntrinsics(707.09, 707.09, 601.89, 183.11), name)
