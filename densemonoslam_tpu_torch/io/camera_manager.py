"""Camera managers: uniform discovery/ingest over logs and live streams (a
numpy copy of `densemonoslam_tpu.io.camera_manager`).

Equivalents of the reference manager suite
(`GUI/src/Tools/MultiCameraManagerFactory.h:13-45` picks between
`MultiLogCameraManager` for N log files, `MultiLiveCameraManager` for LCM
live streams, `MultiMixedCameraManager` when fewer logs than sensors are
given, and `MultiUsbCameraManager` for OpenNI2/RealSense — the USB path has
no equivalent here).

All managers speak one protocol (the shape `MainController::run`'s per-camera
loop expects, `MainController.cpp:262-400`):

- ``cameras() -> list[str]``            discovered camera names
- ``wait_for_cameras(n, timeout)``      block until n cameras exist
- ``get_next(name, timeout)``           -> (rgb u8 [H,W,3], metric depth f32
                                           [H,W], timestamp) or None
- ``finished(name) -> bool``            end of that camera's stream

Depth is always metric here (each source's depth_factor is applied at the
manager boundary), so multi-source sessions mixing .klg logs and UDP live
streams feed one engine with ``depth_factor=1``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from densemonoslam_tpu_torch.io.stream import FrameReceiver, StreamCameraManager


class LogCamera:
    """One replayed log behind the manager protocol.  Accepts any
    LogReader-protocol reader (KlgReader, TumRgbdReader, IclNuimReader,
    KittiOdometryReader — the reference binds the same LogReader interface,
    `GUI/src/Tools/LogReader.h`)."""

    def __init__(self, reader, depth_factor: float = 1.0):
        self.reader = reader
        self.depth_factor = depth_factor

    def get_next(self) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        if not self.reader.has_more():
            return None
        rgb, depth, ts = self.reader.get_next()
        depth = np.asarray(depth, np.float32)
        if self.depth_factor != 1.0:
            depth = depth / self.depth_factor
        return rgb, depth, float(ts)

    def finished(self) -> bool:
        return not self.reader.has_more()


class MultiLogCameraManager:
    """N replayed logs, one camera each (reference `MultiLogCameraManager`)."""

    def __init__(self, readers: Dict[str, LogCamera]):
        self._cams = dict(readers)

    def cameras(self) -> List[str]:
        return list(self._cams)

    def wait_for_cameras(self, n: int, timeout: float = 0.0) -> bool:
        return len(self._cams) >= n

    def get_next(self, name: str, timeout: float = 0.0):
        return self._cams[name].get_next()

    def finished(self, name: str) -> bool:
        return self._cams[name].finished()


# Live streams: `StreamCameraManager` (io/stream.py) already speaks the
# protocol — cameras appear dynamically on their first UDP packet, the
# reference `MultiLiveCameraManager`/LcmHandler role.
MultiLiveCameraManager = StreamCameraManager


class MultiMixedCameraManager:
    """Logs + live streams in one session (reference
    `MultiMixedCameraManager`: "logs < sensors: some live").  Log cameras are
    known immediately; live cameras join as their packets arrive."""

    def __init__(self, logs: MultiLogCameraManager, live: StreamCameraManager):
        self.logs = logs
        self.live = live

    def cameras(self) -> List[str]:
        return self.logs.cameras() + list(self.live.cameras())

    def wait_for_cameras(self, n: int, timeout: float = 5.0) -> bool:
        n_live = max(0, n - len(self.logs.cameras()))
        if n_live == 0:
            return True
        return self.live.wait_for_cameras(n_live, timeout)

    def _owner(self, name: str):
        return self.logs if name in self.logs.cameras() else self.live

    def get_next(self, name: str, timeout: float = 1.0):
        owner = self._owner(name)
        if owner is self.logs:
            return owner.get_next(name)
        return owner.get_next(name, timeout)

    def finished(self, name: str) -> bool:
        return self._owner(name).finished(name)


def make_camera_manager(
    log_paths: List[str],
    width: int,
    height: int,
    n_sensors: Optional[int] = None,
    live_port: Optional[int] = None,
    depth_factor: float = 1000.0,
):
    """Pick a manager for the session (reference
    `MultiCameraManagerFactory.h:13-45` decision: all logs / all live /
    mixed).  `.klg` paths get a `KlgReader`; directories are auto-detected as
    TUM (has rgb.txt/assoc) or ICL (png sequence) roots."""
    from densemonoslam_tpu_torch.io.klg import KlgReader

    cams: Dict[str, LogCamera] = {}
    for i, path in enumerate(log_paths or []):
        name = f"cam{i}"
        if path.endswith(".klg"):
            # KlgReader emits metric depth already (its own depth_factor)
            cams[name] = LogCamera(
                KlgReader(path, width, height, depth_factor=depth_factor)
            )
        else:
            import os

            from densemonoslam_tpu_torch.io.datasets import (
                IclNuimReader, TumRgbdReader,
            )

            is_tum = any(
                os.path.exists(os.path.join(path, f))
                for f in ("rgb.txt", "associations.txt", "assoc.txt")
            )
            reader = TumRgbdReader(path) if is_tum else IclNuimReader(path)
            # dataset readers emit raw uint16 depth — metricise here
            cams[name] = LogCamera(reader, depth_factor=depth_factor)
    n_sensors = n_sensors if n_sensors is not None else max(len(cams), 1)
    want_live = live_port is not None and len(cams) < n_sensors
    if cams and not want_live:
        return MultiLogCameraManager(cams)
    live = StreamCameraManager(
        FrameReceiver(port=live_port or 0), depth_factor=depth_factor
    )
    if not cams:
        return live
    return MultiMixedCameraManager(MultiLogCameraManager(cams), live)


def run_session(
    engine,
    manager,
    max_frames: int,
    viewer=None,
    viewer_interval: int = 4,
    wait_timeout: float = 1.0,
) -> Dict[str, int]:
    """Round-robin multi-camera loop (reference `MainController::run`'s
    per-camera iteration, `MainController.cpp:262-400`): each discovered
    camera gets its own engine frontend (and initially its own map); maps
    merge when inter-map fern loops resolve (`Engine._try_intermap`).  Live
    managers can grow the camera set mid-session (the reference's
    dynamic-device LcmHandler behaviour).  Returns frames processed per
    camera."""
    processed: Dict[str, int] = {}
    idle_rounds = 0
    while max(processed.values(), default=0) < max_frames:
        names = list(manager.cameras())
        if not names:
            time.sleep(0.05)
            idle_rounds += 1
            if idle_rounds > int(20 * wait_timeout):
                break
            continue
        any_frame = False
        for name in names:
            if processed.get(name, 0) >= max_frames or manager.finished(name):
                continue
            frame = manager.get_next(name, timeout=wait_timeout)
            if frame is None:
                continue
            rgb, depth_m, ts = frame
            engine.frontend(name)
            if viewer is not None:
                viewer.sync(names)
            engine.process_frame(name, rgb, depth_m, ts, sync=False)
            processed[name] = processed.get(name, 0) + 1
            any_frame = True
            if viewer is not None and processed[name] % viewer_interval == 0:
                viewer.publish(name)
        if not any_frame:
            if all(
                manager.finished(n) or processed.get(n, 0) >= max_frames
                for n in names
            ):
                break
            idle_rounds += 1
            if idle_rounds > int(20 * wait_timeout):
                break
        else:
            idle_rounds = 0
    return processed
