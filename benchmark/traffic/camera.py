"""The camera description the frozen generators read: a resolution and
pinhole intrinsics, nothing else."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FrameResolution:
    width: int
    height: int


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    resolution: FrameResolution
    intrinsics: CameraIntrinsics
    name: str = "cam0"
