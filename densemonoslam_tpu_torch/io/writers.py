"""Session export writers: `.freiburg` trajectories and `.ply` surfel maps.

Byte-format-compatible with the reference's exports so the same external
evaluation tooling can be pointed at either system:
- trajectory: `Context::saveTrajectory` (`Core/src/Context.h:117-156`) writes
  `ts tx ty tz qx qy qz qw` lines;
- map: `ElasticFusion::savePly` (`Core/src/ElasticFusion.cpp:781-890`) writes a
  binary-little-endian PLY with x y z nx ny nz red green blue radius
  per stable surfel.
It also encodes the viewer's and `Engine.save_view_images`' PNG images with
the standard library alone (`png_bytes`), so they need no imaging package.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def save_freiburg(path: str, timestamps: Sequence[float], poses: Sequence[np.ndarray]) -> None:
    """Write a TUM-format trajectory (`ts tx ty tz qx qy qz qw`)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            T = np.asarray(T)
            q = _mat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def save_ply(
    path: str,
    positions: np.ndarray,
    normals: np.ndarray,
    colors: np.ndarray,
    radii: np.ndarray,
) -> None:
    """Binary-little-endian PLY of a surfel cloud (same fields/order as the
    reference `savePly`: x y z nx ny nz red green blue radius)."""
    n = positions.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float radius\n"
        "end_header\n"
    )
    rec = np.empty(
        n,
        dtype=[
            ("xyz", "<f4", 3),
            ("n", "<f4", 3),
            ("rgb", "u1", 3),
            ("r", "<f4"),
        ],
    )
    rec["xyz"] = positions.astype(np.float32)
    rec["n"] = normals.astype(np.float32)
    rec["rgb"] = np.clip(colors, 0, 255).astype(np.uint8)
    rec["r"] = radii.astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def load_ply(path: str):
    """Read back a PLY written by `save_ply` (for round-trip tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int(
            next(
                line.split()[-1]
                for line in header.decode().splitlines()
                if line.startswith("element vertex")
            )
        )
        rec = np.frombuffer(
            f.read(),
            dtype=[("xyz", "<f4", 3), ("n", "<f4", 3), ("rgb", "u1", 3), ("r", "<f4")],
            count=n,
        )
    return rec["xyz"].copy(), rec["n"].copy(), rec["rgb"].copy(), rec["r"].copy()


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF
    )


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 image, greyscale [H,W] or RGB [H,W,3]: one
    IDAT of zlib-deflated scanlines, each with filter type 0."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"png_bytes takes [H,W] or [H,W,3] uint8, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )
