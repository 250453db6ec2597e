"""ctypes bindings for the native frame codec library (a numpy/ctypes copy of
`densemonoslam_tpu.io.native`, with its own build).

The codec (zlib depth, JPEG RGB, `.klg` scanning and decoding, and a
prefetching `.klg` reader with a pool of decode threads) is the C++ source
`native/framecodec.cpp`.  This module compiles its own copy of it with the
flags of `native/Makefile` into `build/native/libframecodec_<hash>.so`,
named after a hash of the source and the flags and written under a
temporary name that is renamed into place, so processes that build at the
same time never load a partial file.  The build runs at first use (the
first codec call, or the first read of `HAVE_NATIVE` / `HAVE_PREFETCH`),
never at import.

Every entry point has a pure-Python fallback (the `zlib` module, and PIL
for JPEG), used when the library cannot be built or loaded;
`HAVE_NATIVE` says which path is active and `BUILD_ERROR` why the library
is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "framecodec.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-lz", "-ljpeg", "-lpthread"]

_P = ctypes.POINTER
_u8p = _P(ctypes.c_uint8)
_SIGNATURES = {
    "dms_zlib_compress": (ctypes.c_long, [_u8p, ctypes.c_long, _u8p, ctypes.c_long]),
    "dms_zlib_decompress": (ctypes.c_long, [_u8p, ctypes.c_long, _u8p, ctypes.c_long]),
    "dms_jpeg_decode": (ctypes.c_int, [
        _u8p, ctypes.c_long, _u8p, ctypes.c_int, ctypes.c_int,
        _P(ctypes.c_int), _P(ctypes.c_int),
    ]),
    "dms_jpeg_encode": (ctypes.c_long, [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long,
    ]),
    "dms_klg_scan": (ctypes.c_long, [
        ctypes.c_char_p, _P(ctypes.c_long), _P(ctypes.c_int64), _P(ctypes.c_int32),
        _P(ctypes.c_int32), ctypes.c_long,
    ]),
    "dms_klg_read_frame": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int32, ctypes.c_int32, _u8p,
        ctypes.c_long, _u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]),
}
_PREFETCH_SIGNATURES = {
    "dms_prefetch_open": (ctypes.c_void_p, [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]),
    "dms_prefetch_next": (ctypes.c_long, [
        ctypes.c_void_p, _u8p, _u8p, _P(ctypes.c_int64),
    ]),
    "dms_prefetch_frames": (ctypes.c_long, [ctypes.c_void_p]),
    "dms_prefetch_close": (None, [ctypes.c_void_p]),
}

# (library or None, prefetch available, reason the library is missing):
# set by the first `_native()` call of the process
_STATE: Optional[Tuple[Optional[ctypes.CDLL], bool, Optional[str]]] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libframecodec_{key}.so"


def build() -> Path:
    """Compile `native/framecodec.cpp` unless its library exists; return the
    library's path.  Raises with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _declare(lib: ctypes.CDLL, signatures: dict) -> None:
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _native():
    """The loaded codec library (built on the first call) or None."""
    global _STATE
    if _STATE is None:
        try:
            lib = ctypes.CDLL(str(build()))
            _declare(lib, _SIGNATURES)
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _STATE = (None, False, str(e))
        else:
            try:
                _declare(lib, _PREFETCH_SIGNATURES)
                prefetch = True
            except AttributeError:
                prefetch = False
            _STATE = (lib, prefetch, None)
    return _STATE[0]


def __getattr__(name: str):
    # HAVE_NATIVE / HAVE_PREFETCH / BUILD_ERROR build the library on first
    # read, so that importing this module builds nothing
    if name == "HAVE_NATIVE":
        return _native() is not None
    if name == "HAVE_PREFETCH":
        return _native() is not None and _STATE[1]
    if name == "BUILD_ERROR":
        _native()
        return _STATE[2]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _buf(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def zlib_compress(data: np.ndarray) -> bytes:
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    lib = _native()
    if lib is not None:
        cap = len(raw) + len(raw) // 2 + 64
        out = np.empty(cap, np.uint8)
        n = lib.dms_zlib_compress(_buf(raw), len(raw), _buf(out), cap)
        if n > 0:
            return out[:n].tobytes()
    return zlib.compress(raw.tobytes(), 1)


def zlib_decompress(data: bytes, out_bytes: int) -> np.ndarray:
    lib = _native()
    if lib is not None:
        src = np.frombuffer(data, np.uint8)
        out = np.empty(out_bytes, np.uint8)
        n = lib.dms_zlib_decompress(_buf(src), len(src), _buf(out), out_bytes)
        if n == out_bytes:
            return out
    return np.frombuffer(zlib.decompress(data), np.uint8).copy()


def jpeg_encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb, np.uint8)
    lib = _native()
    if lib is not None:
        cap = w * h * 3 + 4096
        out = np.empty(cap, np.uint8)
        n = lib.dms_jpeg_encode(_buf(rgb.reshape(-1)), w, h, quality, _buf(out), cap)
        if n > 0:
            return out[:n].tobytes()
    import io

    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "JPEG", quality=quality)
    return b.getvalue()


def jpeg_decode(data: bytes, max_w: int = 4096, max_h: int = 4096) -> np.ndarray:
    lib = _native()
    if lib is not None:
        src = np.frombuffer(data, np.uint8)
        out = np.empty(max_w * max_h * 3, np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = lib.dms_jpeg_decode(
            _buf(src), len(src), _buf(out), max_w, max_h, ctypes.byref(w), ctypes.byref(h)
        )
        if rc == 0:
            return out[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def klg_scan(path: str, max_frames: int = 100000):
    """Scan a .klg log; returns (offsets, timestamps, depth_sizes, image_sizes)."""
    lib = _native()
    if lib is not None:
        offs = np.zeros(max_frames, np.int64)
        ts = np.zeros(max_frames, np.int64)
        ds = np.zeros(max_frames, np.int32)
        iz = np.zeros(max_frames, np.int32)
        n = lib.dms_klg_scan(
            path.encode(),
            offs.ctypes.data_as(_P(ctypes.c_long)),
            ts.ctypes.data_as(_P(ctypes.c_int64)),
            ds.ctypes.data_as(_P(ctypes.c_int32)),
            iz.ctypes.data_as(_P(ctypes.c_int32)),
            max_frames,
        )
        if n >= 0:
            return offs[:n], ts[:n], ds[:n], iz[:n]
    offs, ts, ds, iz = [], [], [], []
    with open(path, "rb") as f:
        f.read(4)  # frame count header
        while True:
            off = f.tell()
            head = f.read(16)
            if len(head) < 16:
                break
            offs.append(off)
            ts.append(int.from_bytes(head[0:8], "little", signed=True))
            ds.append(int.from_bytes(head[8:12], "little", signed=True))
            iz.append(int.from_bytes(head[12:16], "little", signed=True))
            f.seek(ds[-1] + iz[-1], 1)
    return (
        np.asarray(offs, np.int64),
        np.asarray(ts, np.int64),
        np.asarray(ds, np.int32),
        np.asarray(iz, np.int32),
    )


def klg_read_frame(
    path: str, offset: int, depth_size: int, image_size: int, width: int, height: int,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read and decode one klg frame -> (depth u16 [H,W], rgb u8 [H,W,3] or None)."""
    depth_bytes = width * height * 2
    lib = _native()
    if lib is not None:
        depth = np.empty(depth_bytes, np.uint8)
        rgb = np.empty(width * height * 3, np.uint8)
        rc = lib.dms_klg_read_frame(
            path.encode(), offset, depth_size, image_size,
            _buf(depth), depth_bytes, _buf(rgb), width * height * 3, width, height,
        )
        if rc == 0:
            d = depth.view(np.uint16).reshape(height, width).copy()
            r = rgb.reshape(height, width, 3).copy() if image_size > 0 else None
            return d, r
    with open(path, "rb") as f:
        f.seek(offset + 16)
        dbuf = f.read(depth_size)
        ibuf = f.read(image_size)
    if depth_size == depth_bytes:
        d = np.frombuffer(dbuf, np.uint16).reshape(height, width).copy()
    else:
        d = zlib_decompress(dbuf, depth_bytes).view(np.uint16).reshape(height, width)
    r = None
    if image_size == width * height * 3:
        r = np.frombuffer(ibuf, np.uint8).reshape(height, width, 3).copy()
    elif image_size > 0:
        r = jpeg_decode(ibuf, width, height)
    return d, r


class KlgPrefetcher:
    """Prefetching .klg reader: C++ worker threads decode zlib depth and JPEG
    RGB ahead of the consumer into a bounded ring, so host decoding overlaps
    the device's work.  Frames come strictly in order.  Use as a context
    manager or call `close()`."""

    def __init__(
        self, path: str, width: int, height: int, n_threads: int = 3, ring_slots: int = 8,
    ):
        lib = _native()
        if lib is None or not _STATE[1]:
            raise RuntimeError(f"native prefetcher unavailable: {_STATE[2]}")
        self._lib = lib
        self.width = width
        self.height = height
        self._h = lib.dms_prefetch_open(path.encode(), width, height, n_threads, ring_slots)
        if not self._h:
            raise IOError(f"cannot open klg log: {path}")
        self.n_frames = int(lib.dms_prefetch_frames(self._h))

    def __len__(self) -> int:
        return self.n_frames

    def next(self):
        """Blocking next frame -> (index, depth u16 [H,W], rgb u8 [H,W,3],
        timestamp), or None at the end of the log.  Raises on decode errors."""
        if self._h is None:
            return None
        depth = np.empty(self.height * self.width * 2, np.uint8)
        rgb = np.empty(self.height * self.width * 3, np.uint8)
        ts = ctypes.c_int64()
        idx = self._lib.dms_prefetch_next(self._h, _buf(depth), _buf(rgb), ctypes.byref(ts))
        if idx == -1:
            return None
        if idx < 0:
            raise IOError(f"klg prefetch decode error at stream position {idx}")
        return (
            int(idx),
            depth.view(np.uint16).reshape(self.height, self.width),
            rgb.reshape(self.height, self.width, 3),
            int(ts.value),
        )

    def close(self) -> None:
        if self._h is not None:
            self._lib.dms_prefetch_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
