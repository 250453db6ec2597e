"""UDP frame streaming: the LCM-transport equivalent (a numpy copy of
`densemonoslam_tpu.io.stream`, byte for byte the same wire format, so a
sender of either package feeds a receiver of the other).

The reference streams `eflcm::Frame` packets over UDP multicast
(`udpm://239.255.76.67:7667`), one channel for all cameras, demultiplexed by
`senderName`, with devices created on first sight
(`GUI/src/Tools/LcmHandler.h:23-45`, `Tools/networking/LcmReceiver.cpp`).
This module provides the same capability: a `FrameSender` publishes
compressed frames (zlib depth + JPEG RGB via the native codec), a
`FrameReceiver` thread reassembles chunked datagrams and demuxes by sender
into per-camera queues, and `StreamCameraManager` exposes those queues
through the LogReader protocol, creating cameras dynamically — the
`MultiLiveCameraManager` role.

Wire format (little-endian), chunked at 60 KB:
  chunk:   u32 seq | u16 idx | u16 cnt | payload
  payload: u8 flags (1 trackOnly, 2 compressed, 4 last) | u8 name_len | name
           | i32 frame_number | i64 timestamp | u16 w | u16 h
           | i32 depth_size | i32 image_size | depth bytes | image bytes
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

from densemonoslam_tpu_torch.io import native

CHUNK = 60000
DEFAULT_PORT = 7667


def _encode_payload(
    sender: str,
    rgb: np.ndarray,
    depth_u16: np.ndarray,
    frame_number: int,
    timestamp: int,
    compress: bool = True,
    track_only: bool = False,
    last: bool = False,
) -> bytes:
    h, w = depth_u16.shape
    if compress:
        dbytes = native.zlib_compress(depth_u16)
        ibytes = native.jpeg_encode(rgb)
    else:
        dbytes = depth_u16.tobytes()
        ibytes = rgb.tobytes()
    flags = (1 if track_only else 0) | (2 if compress else 0) | (4 if last else 0)
    name = sender.encode()
    head = struct.pack(
        "<BB", flags, len(name)
    ) + name + struct.pack("<iqHHii", frame_number, timestamp, w, h, len(dbytes), len(ibytes))
    return head + dbytes + ibytes


def _decode_payload(data: bytes):
    flags, name_len = struct.unpack_from("<BB", data, 0)
    name = data[2 : 2 + name_len].decode()
    off = 2 + name_len
    frame_number, timestamp, w, h, dsize, isize = struct.unpack_from("<iqHHii", data, off)
    off += struct.calcsize("<iqHHii")
    dbytes = data[off : off + dsize]
    ibytes = data[off + dsize : off + dsize + isize]
    if flags & 2:
        depth = native.zlib_decompress(dbytes, w * h * 2).view(np.uint16).reshape(h, w)
        rgb = native.jpeg_decode(ibytes, w, h) if isize else np.zeros((h, w, 3), np.uint8)
    else:
        depth = np.frombuffer(dbytes, np.uint16).reshape(h, w).copy()
        rgb = (
            np.frombuffer(ibytes, np.uint8).reshape(h, w, 3).copy()
            if isize
            else np.zeros((h, w, 3), np.uint8)
        )
    return {
        "sender": name,
        "rgb": rgb,
        "depth": depth,
        "frame_number": frame_number,
        "timestamp": timestamp,
        "track_only": bool(flags & 1),
        "last": bool(flags & 4),
    }


class FrameSender:
    """Publish frames to a receiver (one per camera process; the reference's
    converter/live sender role)."""

    def __init__(self, sender_name: str, addr: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.name = sender_name
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        self.dest = (addr, port)
        self.seq = np.random.randint(0, 1 << 30)
        self.frame_number = 0

    def send(self, rgb: np.ndarray, depth_u16: np.ndarray, timestamp: Optional[int] = None,
             compress: bool = True, last: bool = False) -> None:
        payload = _encode_payload(
            self.name, rgb, depth_u16, self.frame_number,
            timestamp if timestamp is not None else self.frame_number,
            compress=compress, last=last,
        )
        n = len(payload)
        nchunks = (n + CHUNK - 1) // CHUNK
        for c in range(nchunks):
            part = payload[c * CHUNK : (c + 1) * CHUNK]
            head = struct.pack("<IHH", self.seq & 0xFFFFFFFF, c, nchunks)
            self.sock.sendto(head + part, self.dest)
        self.seq += 1
        self.frame_number += 1

    def close(self) -> None:
        self.sock.close()


class FrameReceiver:
    """Background thread receiving + reassembling frames, demuxed by sender
    (the `LcmReceiver` + `LcmHandler` pair)."""

    def __init__(self, port: int = DEFAULT_PORT, queue_size: int = 16):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        self.sock.bind(("0.0.0.0", port))
        self.port = self.sock.getsockname()[1]  # resolved when port=0
        self.sock.settimeout(0.2)
        self.queues: Dict[str, "queue.Queue"] = {}
        self.queue_size = queue_size
        # per sender: frames reassembled and decoded, and frames the full
        # queue pushed out (UDP's own losses never arrive to be counted)
        self.received: Dict[str, int] = {}
        self.dropped: Dict[str, int] = {}
        self._partial: Dict[int, list] = {}
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self._stop:
            try:
                data, _ = self.sock.recvfrom(8 + CHUNK)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < 8:
                continue
            seq, idx, cnt = struct.unpack_from("<IHH", data, 0)
            part = data[8:]
            if cnt == 1:
                self._deliver(part)
                continue
            slot = self._partial.setdefault(seq, [None] * cnt)
            if idx < len(slot):
                slot[idx] = part
            if all(p is not None for p in slot):
                del self._partial[seq]
                self._deliver(b"".join(slot))
            if len(self._partial) > 64:
                self._partial.clear()  # drop stale reassembly state

    def _deliver(self, payload: bytes) -> None:
        try:
            frame = _decode_payload(payload)
        except Exception:
            return
        sender = frame["sender"]
        q = self.queues.setdefault(sender, queue.Queue(maxsize=self.queue_size))
        self.received[sender] = self.received.get(sender, 0) + 1
        try:
            q.put_nowait(frame)
        except queue.Full:
            try:
                q.get_nowait()  # drop oldest (the reference's circular buffer)
                self.dropped[sender] = self.dropped.get(sender, 0) + 1
                q.put_nowait(frame)
            except queue.Empty:
                pass

    def senders(self):
        return list(self.queues.keys())

    def get(self, sender: str, timeout: float = 1.0):
        q = self.queues.get(sender)
        if q is None:
            deadline = time.time() + timeout
            while sender not in self.queues and time.time() < deadline:
                time.sleep(0.01)
            q = self.queues.get(sender)
            if q is None:
                return None
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop = True
        self.sock.close()
        self.thread.join(timeout=1.0)


class StreamCameraManager:
    """LogReader-protocol adapters over a FrameReceiver, one per discovered
    sender (the `MultiLiveCameraManager` role: cameras appear dynamically on
    their first packet)."""

    def __init__(self, receiver: FrameReceiver, depth_factor: float = 1000.0):
        self.receiver = receiver
        self.depth_factor = depth_factor
        self._done: Dict[str, bool] = {}

    def wait_for_cameras(self, n: int, timeout: float = 5.0) -> bool:
        deadline = time.time() + timeout
        while len(self.receiver.senders()) < n and time.time() < deadline:
            time.sleep(0.02)
        return len(self.receiver.senders()) >= n

    def cameras(self):
        return self.receiver.senders()

    def get_next(self, sender: str, timeout: float = 1.0):
        """(rgb, metric depth, ts) or None."""
        frame = self.receiver.get(sender, timeout)
        if frame is None:
            return None
        if frame["last"]:
            self._done[sender] = True
        return (
            frame["rgb"],
            frame["depth"].astype(np.float32) / self.depth_factor,
            float(frame["timestamp"]),
        )

    def finished(self, sender: str) -> bool:
        return self._done.get(sender, False)
