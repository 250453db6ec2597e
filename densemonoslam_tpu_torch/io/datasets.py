"""Dataset readers: TUM RGB-D associations, ICL-NUIM, KITTI odometry (a
numpy copy of `densemonoslam_tpu.io.datasets`).

Equivalent of the reference's `GUI/src/Tools/LogReader.h` family and the
converter scripts in `logs/` (`kitti_odom_to_lcm.py`, `FreiburgLcm.cpp`,
`iclnuimTolcm.py`).  The reference converts everything into LCM logs and
replays them; we read the original dataset layouts directly (no transport
round-trip needed for a single host) — the streaming path lives in
``densemonoslam_tpu_torch.io.stream``.

All readers implement the same protocol as `SyntheticSequence`:
``has_more() / get_next() -> (rgb u8 [H,W,3], depth f32 metres [H,W], ts)``,
plus `rewind()`, `__len__`, and optional `gt_pose(i)`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _imread_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _imread_depth16(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.uint16)


class TumRgbdReader:
    """TUM RGB-D `associate.py`-style reader.

    Expects a sequence directory containing `rgb/`, `depth/`, and an
    association file (`associated.txt` or `assoc.txt`) with lines
    ``ts_rgb rgb/path ts_depth depth/path`` (either order).  Depth PNGs are
    16-bit with 5000 units/metre (TUM convention; the reference converter
    `FreiburgLcm.cpp` divides by 5).
    """

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, assoc: Optional[str] = None):
        self.root = root
        assoc = assoc or self._find_assoc(root)
        self.entries: List[Tuple[float, str, str]] = []
        with open(assoc) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 4:
                    continue
                ts_a, path_a, _, path_b = parts[0], parts[1], parts[2], parts[3]
                if "depth" in path_a:
                    depth_path, rgb_path = path_a, path_b
                else:
                    rgb_path, depth_path = path_a, path_b
                self.entries.append((float(ts_a), rgb_path, depth_path))
        self._i = 0

    @staticmethod
    def _find_assoc(root: str) -> str:
        for name in ("associated.txt", "assoc.txt", "associations.txt"):
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no association file found under {root}")

    def __len__(self) -> int:
        return len(self.entries)

    def has_more(self) -> bool:
        return self._i < len(self.entries)

    def rewind(self) -> None:
        self._i = 0

    def get_next(self):
        ts, rgb_path, depth_path = self.entries[self._i]
        self._i += 1
        rgb = _imread_rgb(os.path.join(self.root, rgb_path))
        depth = _imread_depth16(os.path.join(self.root, depth_path)).astype(np.float32)
        return rgb, depth * self.DEPTH_SCALE, ts


class IclNuimReader:
    """ICL-NUIM png-directory reader (reference converter
    `logs/rgbd/iclnuimTolcm.py`): frames `rgb/%d.png` + `depth/%d.png`,
    depth 16-bit in 1/5000 m like TUM's re-exported copies.  Remember to run
    the engine with `icl_nuim=True` (normal flip, reference `--icl`)."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, start: int = 0):
        self.root = root
        rgb_dir = os.path.join(root, "rgb")
        n = len([f for f in os.listdir(rgb_dir) if f.endswith(".png")])
        self.indices = list(range(start, start + n))
        self._i = 0

    def __len__(self) -> int:
        return len(self.indices)

    def has_more(self) -> bool:
        return self._i < len(self.indices)

    def rewind(self) -> None:
        self._i = 0

    def get_next(self):
        idx = self.indices[self._i]
        self._i += 1
        rgb = _imread_rgb(os.path.join(self.root, "rgb", f"{idx}.png"))
        depth = _imread_depth16(os.path.join(self.root, "depth", f"{idx}.png"))
        return rgb, depth.astype(np.float32) * self.DEPTH_SCALE, float(idx)


class KittiOdometryReader:
    """KITTI odometry grayscale/colour sequence reader (reference converter
    `logs/kitti/kitti_odom_to_lcm.py`): `image_2/%06d.png` colour frames,
    optional precomputed depth dir (uint16 mm — the converter writes
    depth*1000, :65-75), resized to the network feed size with intrinsics
    corrected the same way (`corrected_intrinsics`, :34-52)."""

    def __init__(
        self,
        seq_dir: str,
        depth_dir: Optional[str] = None,
        feed_width: int = 1024,
        feed_height: int = 320,
    ):
        self.seq_dir = seq_dir
        self.depth_dir = depth_dir
        self.feed = (feed_width, feed_height)
        img_dir = os.path.join(seq_dir, "image_2")
        self.frames = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
        self._i = 0

    def __len__(self) -> int:
        return len(self.frames)

    def has_more(self) -> bool:
        return self._i < len(self.frames)

    def rewind(self) -> None:
        self._i = 0

    def get_next(self):
        from PIL import Image

        name = self.frames[self._i]
        ts = float(self._i)
        self._i += 1
        img = Image.open(os.path.join(self.seq_dir, "image_2", name)).convert("RGB")
        img = img.resize(self.feed, Image.BILINEAR)
        rgb = np.asarray(img, dtype=np.uint8)
        if self.depth_dir is not None:
            d = Image.open(os.path.join(self.depth_dir, name))
            d = d.resize(self.feed, Image.NEAREST)
            depth = np.asarray(d, dtype=np.uint16).astype(np.float32) / 1000.0
        else:
            depth = np.zeros((self.feed[1], self.feed[0]), np.float32)
        return rgb, depth, ts


def load_freiburg_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM/"freiburg" trajectory file: `ts tx ty tz qx qy qz qw` per
    line.  Returns (timestamps [N], poses [N,4,4])."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts.append(vals[0])
            t = np.array(vals[1:4])
            qx, qy, qz, qw = vals[4:8]
            poses.append(_quat_to_mat(qx, qy, qz, qw, t))
    return np.array(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def _quat_to_mat(qx, qy, qz, qw, t) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class GroundTruthOdometry:
    """Timestamp-interpolated ground-truth pose server (reference
    `GUI/src/Tools/GroundTruthOdometry.cpp:31-55`: loads a trajectory and
    serves the pose nearest/interpolated at a query timestamp, used by the
    `--poses` injection path)."""

    def __init__(self, path: str):
        self.ts, self.poses = load_freiburg_trajectory(path)

    def pose_at(self, t: float) -> np.ndarray:
        """Pose at timestamp t: nearest-neighbour below, linearly interpolated
        translation and slerp-free (nearest) rotation for small steps."""
        i = int(np.searchsorted(self.ts, t, side="right")) - 1
        i = int(np.clip(i, 0, len(self.ts) - 1))
        if i + 1 >= len(self.ts) or self.ts[i + 1] == self.ts[i]:
            return self.poses[i]
        a = (t - self.ts[i]) / (self.ts[i + 1] - self.ts[i])
        a = float(np.clip(a, 0.0, 1.0))
        T = self.poses[i].copy()
        T[:3, 3] = (1 - a) * self.poses[i][:3, 3] + a * self.poses[i + 1][:3, 3]
        if a > 0.5:
            T[:3, :3] = self.poses[i + 1][:3, :3]
        return T


class GroundTruthClusters:
    """Per-timestamp semantic/GT cluster ids (reference
    `GUI/src/Tools/GroundTruthClusters.cpp`: "time,cluster" CSV lines; serves
    the `cluster` argument of `processFrame`, which tags surfels so the map
    can be exported per cluster).  Colors follow the reference's HSV wheel."""

    def __init__(self, path: str):
        self.clusters: dict = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    t_str, c_str = line.split(",")[:2]
                    self.clusters[int(float(t_str))] = int(c_str)
                except ValueError:
                    continue
        self._ts = np.array(sorted(self.clusters), dtype=np.int64)
        ids = sorted(set(self.clusters.values()))
        n = max(len(ids), 1)
        self.cluster_colors = {}
        for c in ids:
            h = 360.0 * float(c) / n

            def f(x, h=h):
                k = ((x + h / 60.0)) % 6.0
                return 1.0 - max(min(k, min(4.0 - k, 1.0)), 0.0)

            self.cluster_colors[c] = (f(5.0), f(3.0), f(1.0))

    def cluster_at(self, timestamp: float) -> int:
        """Cluster id at (or nearest below) a timestamp; 0 if none known."""
        if len(self._ts) == 0:
            return 0
        i = int(np.searchsorted(self._ts, int(timestamp), side="right")) - 1
        if i < 0:
            return 0
        return self.clusters[int(self._ts[i])]
