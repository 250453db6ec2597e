"""The one general generator: a cell's traffic parameters and a seed in,
the frames the program is handed out.

A traffic mix is a dict of parameters (a cell file's ``"traffic"``):

- ``trajectory``: ``"orbit"`` (the synthetic room's looping orbit,
  `orbit.SyntheticSequence`) or ``"street"`` (the closed street lap,
  `street.StreetSequence`);
- ``lap``: frames in one lap; frame ``j`` of a run is lap frame
  ``j % lap``: every run starts at the lap's frame 0, since a start
  drawn from the seed would change the work a window holds;
- ``sequence``: the generator's own keyword arguments (radius, angle,
  noise, jitter, scene seed);
- ``warmup_frames``: frames handed over in set-up, before the window;
- ``rate_hz``: 0 hands frames over back to back, as a log replay does; a
  positive rate offers frame ``j`` at ``j / rate_hz`` seconds into the
  window, as a live sensor does;
- ``render``: ``"host"`` (default) or ``"device"`` (the street only:
  `street_device`, the same frames from float64 on the run's device, where
  the host's render would take most of the set-up).

Every lap frame is rendered once per run, as host numpy arrays (``rgb``
uint8 ``[H, W, 3]``, ``depth`` float32 metres ``[H, W]``), on the host by a
pool of spawned processes (one per core but one, at most 8) or on the
device.  A mix whose ``depth`` is
``"predicted"`` hands over no depth: the program predicts it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from typing import List, Optional, Tuple

import numpy as np

from .camera import CameraConfig, CameraIntrinsics, FrameResolution
from .orbit import SyntheticSequence
from .street import StreetSequence

_KINDS = {"orbit": SyntheticSequence, "street": StreetSequence}
_SEQ = None  # a render worker's sequence


@dataclasses.dataclass
class Traffic:
    lap_frames: List[Tuple[np.ndarray, Optional[np.ndarray]]]
    gt_poses: List[np.ndarray]  # camera-to-world, per lap frame
    warmup: int
    rate_hz: float

    def index(self, j: int) -> int:
        """Lap frame of run frame `j`."""
        return j % len(self.lap_frames)

    def frame(self, j: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return self.lap_frames[self.index(j)]

    def gt_pose(self, j: int) -> np.ndarray:
        return self.gt_poses[self.index(j)]


def camera_of(config: dict) -> CameraConfig:
    """The camera of a configuration file's ``"camera"`` entry."""
    c = config["camera"]
    return CameraConfig(FrameResolution(int(c["width"]), int(c["height"])),
                        CameraIntrinsics(float(c["fx"]), float(c["fy"]),
                                         float(c["cx"]), float(c["cy"])))


def _sequence(traffic: dict, camera: CameraConfig):
    kind = _KINDS[traffic["trajectory"]]
    return kind(camera=camera, num_frames=int(traffic["lap"]), **traffic.get("sequence", {}))


def _init(traffic: dict, camera: CameraConfig) -> None:
    global _SEQ
    _SEQ = _sequence(traffic, camera)


def _render(i: int):
    return _SEQ.frame(i)


def make(traffic: dict, camera: CameraConfig, workers: int = 0, device=None) -> Traffic:
    """Render the lap of `traffic` for `camera`.  `workers` processes
    render it on the host (0: one per core but one, at most 8); a mix
    rendered on the device uses `device`."""
    lap = int(traffic["lap"])
    seq = _sequence(traffic, camera)
    if workers <= 0:
        workers = max(min(len(os.sched_getaffinity(0)) - 1, 8), 1)
    if traffic.get("render", "host") == "device":
        from . import street_device

        frames = [street_device.frame(seq, i, device) for i in range(lap)]
    elif workers == 1:
        frames = [seq.frame(i) for i in range(lap)]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers, initializer=_init, initargs=(traffic, camera)) as pool:
            frames = pool.map(_render, range(lap), chunksize=1)
    if traffic.get("depth") == "predicted":
        frames = [(rgb, None) for rgb, _ in frames]
    return Traffic(
        lap_frames=frames,
        gt_poses=[np.asarray(seq.gt_pose(i), np.float64) for i in range(lap)],
        warmup=int(traffic["warmup_frames"]),
        rate_hz=float(traffic.get("rate_hz", 0.0)),
    )
