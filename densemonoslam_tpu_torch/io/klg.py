""".klg log reader/writer (a numpy copy of `densemonoslam_tpu.io.klg`; the
reference's RawLogReader format: `GUI/src/Tools/RawLogReader.cpp`,
converters `logs/rgbd/Freiburg.cpp`).  A log written by either package
reads back identically in the other.

Record layout: `int32 numFrames` header, then per frame
`int64 timestamp, int32 depthSize, int32 imageSize, depth..., image...`
with depth zlib-compressed uint16 (or raw) and image JPEG (or raw RGB).
Decoding uses the native codec library when it builds (`io/native.py`
compiles `native/framecodec.cpp`), otherwise the Python fallback.
"""

from __future__ import annotations

import struct

import numpy as np

from densemonoslam_tpu_torch.io import native


class KlgReader:
    """LogReader-protocol reader for .klg files.

    With ``prefetch=True`` (the default when the native library is built),
    sequential reads are served by the C++ async prefetch executor
    (`native/framecodec.cpp` `dms_prefetch_*`): a worker pool decodes frames
    ahead of the consumer — the reference's LCM-receive-thread +
    CircularBuffer pattern for log replay.  Random access (`rewind`/
    `fast_forward`) transparently re-syncs the stream.
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        depth_factor: float = 1000.0,
        prefetch: bool = True,
    ):
        self.path = path
        self.width = width
        self.height = height
        self.depth_factor = depth_factor
        self.offsets, self.timestamps, self.depth_sizes, self.image_sizes = (
            native.klg_scan(path)
        )
        self._i = 0
        self._want_prefetch = prefetch and native.HAVE_PREFETCH
        self._pf = None  # lazily opened; tracks its own position via _pf_i
        self._pf_i = 0

    def __len__(self) -> int:
        return len(self.offsets)

    def has_more(self) -> bool:
        return self._i < len(self.offsets)

    def rewind(self) -> None:
        self._i = 0
        self._drop_prefetcher()

    def fast_forward(self, frame: int) -> None:
        self._i = min(frame, len(self.offsets))

    def close(self) -> None:
        self._drop_prefetcher()

    def _drop_prefetcher(self) -> None:
        if self._pf is not None:
            self._pf.close()
            self._pf = None
        self._pf_i = 0

    def _next_prefetched(self, i: int):
        if self._pf is None:
            self._pf = native.KlgPrefetcher(self.path, self.width, self.height)
            self._pf_i = 0
        if self._pf_i > i:  # stream is past the wanted frame: restart
            self._drop_prefetcher()
            return self._next_prefetched(i)
        out = None
        while self._pf_i <= i:  # drain skipped frames (fast_forward)
            out = self._pf.next()
            self._pf_i += 1
            if out is None:
                return None
        return out

    def get_next(self):
        i = self._i
        self._i += 1
        if self._want_prefetch:
            try:
                out = self._next_prefetched(i)
            except IOError:
                out = None  # decode error: fall back to the direct path
            if out is not None:
                _, depth, rgb, ts = out
                return (
                    rgb,
                    depth.astype(np.float32) / self.depth_factor,
                    float(ts),
                )
        depth, rgb = native.klg_read_frame(
            self.path,
            int(self.offsets[i]),
            int(self.depth_sizes[i]),
            int(self.image_sizes[i]),
            self.width,
            self.height,
        )
        if rgb is None:
            rgb = np.zeros((self.height, self.width, 3), np.uint8)
        return rgb, depth.astype(np.float32) / self.depth_factor, float(self.timestamps[i])


def write_klg(
    path: str,
    frames,  # iterable of (rgb u8 [H,W,3], depth u16 [H,W], timestamp int)
    compress: bool = True,
    jpeg_quality: int = 90,
) -> int:
    """Write a .klg log (the converter role of `logs/rgbd/Freiburg.cpp`).
    Returns the number of frames written."""
    records = []
    for rgb, depth, ts in frames:
        depth = np.ascontiguousarray(depth, np.uint16)
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if compress:
            dbytes = native.zlib_compress(depth)
            ibytes = native.jpeg_encode(rgb, jpeg_quality)
        else:
            dbytes = depth.tobytes()
            ibytes = rgb.tobytes()
        records.append((int(ts), dbytes, ibytes))
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(records)))
        for ts, dbytes, ibytes in records:
            f.write(struct.pack("<qii", ts, len(dbytes), len(ibytes)))
            f.write(dbytes)
            f.write(ibytes)
    return len(records)
