"""The one general generator: a cell's traffic parameters and a seed in,
the frames the program is handed out.

A traffic mix is a dict of parameters (a cell file's ``"traffic"``):

- ``trajectory``: ``"orbit"`` (the synthetic room's looping orbit,
  `orbit.SyntheticSequence`), ``"street"`` (the closed street lap,
  `street.StreetSequence`), or the name of a file ``<name>.py`` beside
  this one whose ``Sequence`` class takes ``camera``, ``num_frames`` and
  the ``sequence`` arguments and gives ``frame(i)`` and ``gt_pose(i)``;
- ``lap``: frames in one lap; frame ``j`` of a camera's run is lap frame
  ``(offset + j) % lap``: every run starts at the same lap frame, since a
  start drawn from the seed would change the work a window holds;
- ``offset`` (default 0): the lap frame a camera's run starts at;
- ``join`` (default 0): the session tick at which a camera hands over its
  first frame (a tick hands over one frame of every camera that has
  joined, in camera order);
- ``sequence``: the generator's own keyword arguments (radius, angle,
  noise, jitter, scene seed);
- ``warmup_frames``: frames handed over in set-up, before the window;
- ``rate_hz``: 0 hands frames over back to back, as a log replay does; a
  positive rate offers frame ``j`` at ``j / rate_hz`` seconds into the
  window, as a live sensor does;
- ``render``: ``"host"`` (default) or ``"device"`` (the street only:
  `street_device`, the same frames from float64 on the run's device, where
  the host's render would take most of the set-up);
- ``per_camera``: for a configuration of several ``cameras``, one dict a
  camera, each merged over the other keys for that camera (``sequence``,
  ``lap``, ``offset``, ``join``); without it every camera takes the mix
  as it is.

Every lap frame is rendered once per run (cameras whose mixes differ only
in ``offset`` and ``join`` share one render), as host numpy arrays (``rgb``
uint8 ``[H, W, 3]``, ``depth`` float32 metres ``[H, W]``), on the host by a
pool of spawned processes (one per core but one, at most 8) or on the
device.  A mix whose ``depth`` is
``"predicted"`` hands over no depth: the program predicts it.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import multiprocessing
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from .camera import CameraConfig, CameraIntrinsics, FrameResolution
from .orbit import SyntheticSequence
from .street import StreetSequence

_KINDS = {"orbit": SyntheticSequence, "street": StreetSequence}
_MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
_PLACE = ("offset", "join")  # where a camera's run lies in the lap and the session
_SEQ = None  # a render worker's sequence


@dataclasses.dataclass
class Traffic:
    lap_frames: List[Tuple[np.ndarray, Optional[np.ndarray]]]
    gt_poses: List[np.ndarray]  # camera-to-world, per lap frame
    warmup: int  # frames this camera hands over in the set-up
    rate_hz: float
    offset: int = 0
    join: int = 0

    def index(self, j: int) -> int:
        """Lap frame of run frame `j`."""
        return (self.offset + j) % len(self.lap_frames)

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


def _kind(name: str):
    """The sequence class of trajectory `name`: a kind of this module, or
    the ``Sequence`` class of the file ``<name>.py`` beside it."""
    if name in _KINDS:
        return _KINDS[name]
    if not _MODULE.match(name):
        raise ValueError(f"trajectory {name!r} is not a module name")
    mod = importlib.import_module(f".{name}", __package__)
    if not hasattr(mod, "Sequence"):
        raise ValueError(f"traffic/{name}.py has no Sequence class")
    return mod.Sequence


def _sequence(traffic: dict, camera: CameraConfig):
    kind = _kind(traffic["trajectory"])
    return kind(camera=camera, num_frames=int(traffic["lap"]), **traffic.get("sequence", {}))


def _init(traffic: dict, camera: CameraConfig) -> None:
    global _SEQ
    _SEQ = _sequence(traffic, camera)


def _render(i: int):
    return _SEQ.frame(i)


def make_cameras(traffic: dict, camera: CameraConfig, cameras: int, device=None) -> list:
    """One `Traffic` a camera: its ``per_camera`` entry merged over the
    mix's other keys.  A lap is rendered once for every camera whose mix
    gives it.  The set-up's ticks (``warmup_frames``) are the cell's."""
    base = {k: v for k, v in traffic.items() if k != "per_camera"}
    own = traffic.get("per_camera", [{}] * cameras)
    if len(own) != cameras:
        raise ValueError(f"per_camera has {len(own)} entries for {cameras} cameras")
    laps: dict = {}
    out = []
    for mix in (dict(base, **o) for o in own):
        key = json.dumps({k: v for k, v in mix.items() if k not in _PLACE}, sort_keys=True)
        if key not in laps:
            laps[key] = make(mix, camera, device=device)
        join = int(mix.get("join", 0))
        out.append(dataclasses.replace(laps[key], offset=int(mix.get("offset", 0)), join=join,
                                       warmup=max(int(base["warmup_frames"]) - join, 0)))
    return out


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
