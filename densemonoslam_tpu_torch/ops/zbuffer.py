"""The render of the whole surfel map in two launches (kernel K3,
`csrc/zbuffer.cu`): a rows pass that z-buffers the rows below the count
with one 64-bit `atomicMin` each on a (depth, row) key, and a pixels pass
that resolves each pixel's disk over the winners of its neighbourhood and
writes the prediction.

`splat.render` dispatches here on the card for every render with no active
window of a map of more than 1<<21 rows (`splat.full_map`), where the op-by-op
path (`splat.render_ops`, K3's plain version, which the CPU keeps) would
take the exact two-scatter z-buffer over every row of the capacity.  The
result is that path's, winner for winner: the key orders as (z, row), so the
least depth wins and the lower row breaks a tie.

Only CUDA tensors are taken.  The kernel is built and loaded as
`ops.track_iter`'s is (`ops.cuda_build`), without FMA contraction; each call
adds one to `utils.launches` under ``("zbuffer", mode)``, mode ``active``,
``inactive`` or ``all``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.utils import launches

MODES = ("active", "inactive", "all")  # splat.MODE_ACTIVE, MODE_INACTIVE, MODE_ALL
MAX_SPLAT_K = 7  # csrc/zbuffer.cu MAX_HALF = 3
# the device type the kernel runs on: a call with tensors elsewhere raises
KERNEL_DEVICE = "cuda"


class _Params(ctypes.Structure):
    """Mirror of `zbuffer::Params` (checked against its size at load)."""

    _fields_ = [
        ("data", ctypes.c_void_p), ("count", ctypes.c_void_p), ("tinv", ctypes.c_void_p),
        ("time", ctypes.c_void_p), ("keys", ctypes.c_void_p),
        ("n_rows", ctypes.c_longlong), ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("mode", ctypes.c_int), ("half", ctypes.c_int),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float), ("cx", ctypes.c_float),
        ("cy", ctypes.c_float), ("inv_fx", ctypes.c_float), ("inv_fy", ctypes.c_float),
        ("time_delta", ctypes.c_float), ("depth_max", ctypes.c_float), ("r_max", ctypes.c_float),
        ("index", ctypes.c_void_p), ("vmap", ctypes.c_void_p), ("nmap", ctypes.c_void_p),
        ("color", ctypes.c_void_p), ("intensity", ctypes.c_void_p), ("depth", ctypes.c_void_p),
        ("time_out", ctypes.c_void_p), ("conf", ctypes.c_void_p), ("cell", ctypes.c_void_p),
    ]


_launch = None  # the library's `zbuffer_render_f32`, once loaded


def _declare(lib: ctypes.CDLL) -> None:
    lib.zbuffer_render_f32.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    lib.zbuffer_render_f32.restype = ctypes.c_int
    lib.zbuffer_params_bytes.argtypes = []
    lib.zbuffer_params_bytes.restype = ctypes.c_int


def _load():
    global _launch
    if _launch is None:
        from densemonoslam_tpu_torch.ops import cuda_build

        lib = cuda_build.load("zbuffer", _declare)
        if lib.zbuffer_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"zbuffer: Params is {lib.zbuffer_params_bytes()} bytes in the library, "
                f"{ctypes.sizeof(_Params)} in its binding"
            )
        _launch = lib.zbuffer_render_f32
    return _launch


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise `ValueError` unless `t` has `dtype` and `shape`, is contiguous
    and lives on `device`, a device of the kernel's type."""
    if t.dtype != dtype:
        raise ValueError(f"zbuffer: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"zbuffer: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"zbuffer: {name} must be contiguous")
    if t.device.type != KERNEL_DEVICE or t.device != device:
        raise ValueError(f"zbuffer: {name} is on {t.device}; the kernel runs on "
                         f"{KERNEL_DEVICE} only, with every tensor on the map's device")


def render_full(
    data: torch.Tensor,  # [N+1, 16] f32 surfel rows (sm layout)
    count: torch.Tensor,  # [] int64 rows in use
    tinv: torch.Tensor,  # [4, 4] f32 world-to-camera (`se3.se3_inverse` of the pose)
    t_now: torch.Tensor,  # [] f32 the render's tick
    intr: CameraIntrinsics,
    width: int,
    height: int,
    *,
    time_delta: int,
    mode: int,
    splat_k: int,
    depth_max: float,
) -> Tuple[torch.Tensor, ...]:
    """The prediction of `splat.render_ops` at these arguments (no window),
    as its fields in `splat.Prediction`'s order: index, vmap, nmap, color,
    intensity, depth, time, conf, cell."""
    if data.dim() != 2 or data.shape[1] != 16:
        raise ValueError(f"zbuffer: data must be [N+1, 16], got {tuple(data.shape)}")
    n_rows = data.shape[0] - 1
    dev = data.device
    _check("data", data, torch.float32, tuple(data.shape), dev)
    _check("count", count, torch.int64, (), dev)
    _check("tinv", tinv, torch.float32, (4, 4), dev)
    _check("t_now", t_now, torch.float32, (), dev)
    if data.data_ptr() % 16:
        raise ValueError("zbuffer: data must start on a 16-byte boundary")
    if not 0 <= n_rows < 2**31:
        raise ValueError(f"zbuffer: {n_rows} rows; the key holds a row in 31 bits")
    if mode not in range(len(MODES)):
        raise ValueError(f"zbuffer: mode {mode} is none of {MODES}")
    if not 1 <= splat_k <= MAX_SPLAT_K:
        raise ValueError(f"zbuffer: splat_k {splat_k} outside 1..{MAX_SPLAT_K}")
    if width <= 0 or height <= 0:
        raise ValueError(f"zbuffer: an image of {width}x{height}")

    def out(*shape, dtype=torch.float32):
        return torch.empty((height, width, *shape), dtype=dtype, device=dev)

    outs = (out(dtype=torch.int64), out(3), out(3), out(3), out(), out(), out(), out(),
            out(dtype=torch.int64))
    keys = torch.empty(height * width, dtype=torch.int64, device=dev)
    prm = _Params(
        data=data.data_ptr(), count=count.data_ptr(), tinv=tinv.data_ptr(),
        time=t_now.data_ptr(), keys=keys.data_ptr(), n_rows=n_rows, width=width,
        height=height, mode=mode, half=splat_k // 2,
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        # torch on the card divides by a Python scalar as a product with its f32 reciprocal
        inv_fx=np.float32(1.0) / np.float32(intr.fx), inv_fy=np.float32(1.0) / np.float32(intr.fy),
        time_delta=time_delta, depth_max=depth_max, r_max=splat_k * 0.75,
        **{name: t.data_ptr() for name, t in zip(
            ("index", "vmap", "nmap", "color", "intensity", "depth", "time_out", "conf", "cell"),
            outs)},
    )
    launch = _load()
    err = launch(ctypes.byref(prm), dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"zbuffer kernel launch failed: cudaError {err}")
    launches.add("zbuffer", MODES[mode])
    return outs
