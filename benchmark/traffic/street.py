"""Street-scale procedural sequence: the KITTI-shaped long-trajectory fixture
(copy of `densemonoslam_tpu.io.street`, numpy only; the same RNG use, so the
frames are bit-equal to the JAX package's).

A ray-cast analytic circular street: ground plane, inner/outer building
walls (cylinders), parked-car-sized spheres along both kerbs for depth
discontinuities, and open sky.  One lap of the drive returns exactly to the
start pose, so place recognition and hybrid loop closure have a true loop to
find, and ATE against the analytic ground truth measures long-range drift.
`depth_noise` / `exposure_jitter` put sensor-model perturbations back in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .camera import CameraConfig, CameraIntrinsics, FrameResolution
from .orbit import _rotation_xyz, _texture

_FAR = 1e9


class StreetScene:
    """Analytic circular street (world frame: x/z horizontal, y DOWN —
    camera convention; the ground is at +`cam_height`, building tops at
    `cam_height - wall_height`)."""

    def __init__(
        self,
        radius: float = 50.0,
        half_width: float = 6.0,
        wall_height: float = 8.0,
        cam_height: float = 1.5,
        n_props: int = 48,
        seed: int = 7,
        aliased: bool = False,
    ):
        self.radius = radius
        self.r_in = radius - half_width
        self.r_out = radius + half_width
        self.ground_y = cam_height
        self.top_y = cam_height - wall_height
        rng = np.random.default_rng(seed)
        # parked props: spheres resting on the ground along both kerbs.
        # `aliased` builds a perceptual-aliasing stressor: the prop layout
        # of the first half-ring is REPEATED rotated by pi, so the street at angle a and a+pi looks locally identical —
        # two visually similar but geometrically distinct places.  Loop
        # retrieval must not close across them.
        if aliased:
            half = n_props // 2
            ang_h = np.sort(rng.uniform(0, np.pi, half))
            ang = np.concatenate([ang_h, ang_h + np.pi])
            side_h = np.where(rng.uniform(size=half) < 0.5, 1.0, -1.0)
            side = np.concatenate([side_h, side_h])
            rad = np.concatenate([rng.uniform(0.5, 1.2, half)] * 2)
        else:
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_props))
            side = np.where(rng.uniform(size=n_props) < 0.5, 1.0, -1.0)
            rad = rng.uniform(0.5, 1.2, n_props)
        r_prop = radius + side * (half_width - 1.6)
        self.sphere_c = np.stack(
            [
                r_prop * np.sin(ang),
                self.ground_y - rad,  # resting on the ground
                -r_prop * np.cos(ang),
            ],
            axis=-1,
        )
        self.sphere_r = rad

    def _cylinder_hit(
        self, o: np.ndarray, d: np.ndarray, R: float, outer: bool
    ) -> np.ndarray:
        """Ray parameter of the wall hit at horizontal radius R (inf if none).
        `outer=False` = inner wall seen from outside (near root), True =
        outer wall seen from inside (far root).  Hits above the roof line or
        below ground are discarded."""
        ox, oz = o[..., 0], o[..., 2]
        dx, dz = d[..., 0], d[..., 2]
        a = dx * dx + dz * dz
        b = ox * dx + oz * dz
        c = ox * ox + oz * oz - R * R
        disc = b * b - a * c
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / np.maximum(a, 1e-12) if not outer else (
            -b + sq
        ) / np.maximum(a, 1e-12)
        y = o[..., 1] + t * d[..., 1]
        ok = ok & (t > 1e-6) & (y > self.top_y) & (y < self.ground_y + 1e-6)
        return np.where(ok, t, _FAR)

    def raycast(
        self, origins: np.ndarray, dirs: np.ndarray, cam_pos: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(t, points, sky_mask).  `cam_pos` prunes props to the near field
        (the prop set is global; testing all of them per frame is wasted)."""
        t = np.full(origins.shape[:-1], _FAR)
        # ground plane (y down: ground below the camera has larger y)
        dy = dirs[..., 1]
        t_g = np.where(dy > 1e-9, (self.ground_y - origins[..., 1]) / np.where(
            np.abs(dy) < 1e-12, 1e-12, dy
        ), _FAR)
        t = np.minimum(t, np.where(t_g > 1e-6, t_g, _FAR))
        # walls
        t = np.minimum(t, self._cylinder_hit(origins, dirs, self.r_in, outer=False))
        t = np.minimum(t, self._cylinder_hit(origins, dirs, self.r_out, outer=True))
        # near-field props only
        near = np.linalg.norm(self.sphere_c - cam_pos[None], axis=-1) < 45.0
        d2 = np.sum(dirs * dirs, axis=-1)
        for c, r in zip(self.sphere_c[near], self.sphere_r[near]):
            oc = origins - c
            b = np.sum(oc * dirs, axis=-1)
            cterm = np.sum(oc * oc, axis=-1) - r * r
            disc = b * b - d2 * cterm
            hit = disc > 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t_s = (-b - sq) / np.maximum(d2, 1e-12)
            t = np.where(hit & (t_s > 1e-6) & (t_s < t), t_s, t)
        sky = t >= _FAR * 0.5
        points = origins + np.where(sky, 0.0, t)[..., None] * dirs
        return t, points, sky


def street_trajectory(
    num_frames: int, radius: float = 50.0, closes: bool = True
) -> list:
    """Camera-to-world poses driving one lap along the street centreline with
    gentle lateral sway and yaw/pitch wobble.  The lap CLOSES (last pose ~=
    first pose) when `closes`, giving the loop the trajectory ground truth."""
    poses = []
    for i in range(num_frames):
        s = i / (num_frames if closes else max(num_frames - 1, 1))
        th = 2.0 * np.pi * s
        sway = 1.2 * np.sin(5.0 * th)
        r = radius + sway
        pos = np.array([r * np.sin(th), 0.0, -r * np.cos(th)])
        fwd = np.array([np.cos(th), 0.0, np.sin(th)])
        down = np.array([0.0, 1.0, 0.0])
        right = np.cross(down, fwd)
        R = np.stack([right, down, fwd], axis=-1)
        # heading wobble (keeps rotation tracking honest)
        R = R @ _rotation_xyz(
            0.02 * np.sin(7.0 * th), 0.05 * np.sin(3.0 * th), 0.01 * np.cos(4.0 * th)
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return poses


def _sky_color(dirs: np.ndarray) -> np.ndarray:
    """Simple vertical sky gradient (y down: smaller y = higher)."""
    h = np.clip(-dirs[..., 1] / np.maximum(np.linalg.norm(dirs, axis=-1), 1e-9), 0, 1)
    base = np.stack([0.55 + 0.2 * h, 0.65 + 0.2 * h, 0.9 - 0.1 * h], axis=-1)
    return np.clip(base, 0, 1)


class StreetSequence:
    """LogReader-equivalent for the street loop (KITTI operating shape).

    Depth is z-depth; sky pixels carry depth 0 (invalid), as a stereo/LiDAR
    KITTI depth map would."""

    def __init__(
        self,
        camera: CameraConfig | None = None,
        num_frames: int = 520,
        radius: float = 50.0,
        depth_noise: float = 0.0,
        exposure_jitter: float = 0.0,
        n_props: int = 48,
        closes: bool = True,
        seed: int = 7,
        aliased: bool = False,
    ):
        if camera is None:
            # quarter-KITTI default keeps CPU tests fast; pass
            # CameraConfig.kitti_default() for the 1024x320 operating point
            res = FrameResolution(256, 80)
            camera = CameraConfig(
                res,
                CameraIntrinsics(707.09 / 4, 707.09 / 4, 601.89 / 4, 183.11 / 4),
                "street",
            )
        self.camera = camera
        self.scene = StreetScene(
            radius=radius, n_props=n_props, seed=seed, aliased=aliased
        )
        self.poses = street_trajectory(num_frames, radius=radius, closes=closes)
        self.depth_noise = depth_noise
        self.exposure_jitter = exposure_jitter
        self._i = 0

    def __len__(self) -> int:
        return len(self.poses)

    def has_more(self) -> bool:
        return self._i < len(self.poses)

    def rewind(self) -> None:
        self._i = 0

    def get_next(self):
        rgb, depth = self.frame(self._i)
        ts = self._i
        self._i += 1
        return rgb, depth, ts

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        intr, res = self.camera.intrinsics, self.camera.resolution
        W, H = res.width, res.height
        u = np.arange(W, dtype=np.float64)
        v = np.arange(H, dtype=np.float64)
        uu, vv = np.meshgrid(u, v)
        rays_cam = np.stack(
            [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, np.ones_like(uu)],
            axis=-1,
        )
        pose = self.poses[i]
        R, t = pose[:3, :3], pose[:3, 3]
        dirs = rays_cam @ R.T
        origins = np.broadcast_to(t, dirs.shape)
        tt, points, sky = self.scene.raycast(origins, dirs, t)
        depth = np.where(sky, 0.0, tt).astype(np.float32)
        col = np.where(sky[..., None], _sky_color(dirs), _texture(points * 0.35))
        rng = np.random.default_rng(98765 + i)
        rgbf = col * 255.0
        if self.exposure_jitter > 0:
            gain = 1.0 + rng.normal(0.0, self.exposure_jitter)
            bias = rng.normal(0.0, self.exposure_jitter * 40.0)
            rgbf = rgbf * gain + bias
        rgb = np.clip(rgbf, 0, 255).astype(np.uint8)
        if self.depth_noise > 0:
            # range-proportional noise (stereo-like): sigma grows with depth
            depth = depth + np.where(
                depth > 0,
                rng.normal(0.0, 1.0, depth.shape) * self.depth_noise * depth,
                0.0,
            ).astype(np.float32)
        return rgb, depth

    def gt_pose(self, i: int) -> np.ndarray:
        return self.poses[i]
