"""One whole dense-tracking iteration per launch (kernel K1 in its fused
form, `csrc/track_iter.cu`): the rows of `ops.reductions`' builders, their
Gram sums, `solve_se3` / `solve_so3` and the frozen-carry update of
`tracking.odometry`, with nothing in between on the host or in device
memory but the carry.

`gn_iteration` runs one joint ICP + RGB Gauss-Newton iteration of a
pyramid level, `so3_iteration` one iteration of the SO3 pre-align.  Each
reads the estimate from a carry buffer and writes the carry the next
iteration reads (`GN_CARRY` / `SO3_CARRY` floats, laid out as the offsets
below say), and returns the reduced sums it solved (`unpack_sums`).  An
exact iteration samples the model at the current estimate; given a
`sample` buffer with `write_sample`, it also keeps that sample for the
frozen iterations after it, which read it.

Only CUDA tensors are taken: the CPU runs the plain composition in
`tracking.odometry`.  The kernel is built and loaded as `ops.gram`'s is
(`ops.cuda_build`); each launch adds one to `utils.launches` under
``("gram", (P, C))``, the K1 shape the rows would have had (C = 16 for the
joint rows, 8 for SO3), and one under ``("track_iter", mode)``: mode
``gn_exact``, ``gn_frozen`` (the sampling iteration among them),
``so3_exact`` or ``so3_frozen``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import cuda_build, reductions
from densemonoslam_tpu_torch.utils import graphs, launches

# GN carry: pose [0:16] (row-major 4x4), the five stats of `_advance`, done (0 / 1)
A = slice(0, 16)
ICP_ERR, ICP_INL, RGB_ERR, RGB_INL = 16, 17, 18, 19
JTJ = slice(20, 56)
DONE = 56
GN_CARRY = 64
# SO3 carry: pose [0:16] (its rotation is the estimate), best rotation, its error, done
SO3_R_BEST = slice(16, 25)
SO3_ERR_BEST, SO3_DONE = 25, 26
SO3_CARRY = 32
GN_SAMPLE, SO3_SAMPLE = 12, 8  # floats of a frozen sample row
GN_SUMS, SO3_SUMS = 58, 11
_GN_BLOCK = 29


class _Params(ctypes.Structure):
    """Mirror of `track_iter::Params` (checked against its size at load)."""

    _fields_ = [
        ("vc", ctypes.c_void_p), ("vc_sy", ctypes.c_longlong), ("vc_sx", ctypes.c_longlong),
        ("nc", ctypes.c_void_p), ("nc_sy", ctypes.c_longlong), ("nc_sx", ctypes.c_longlong),
        ("ic", ctypes.c_void_p), ("ic_sy", ctypes.c_longlong), ("ic_sx", ctypes.c_longlong),
        ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("pack", ctypes.c_void_p), ("Hm", ctypes.c_int), ("Wm", ctypes.c_int),
        ("sample", ctypes.c_void_p), ("write_sample", ctypes.c_int),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float), ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("w2", ctypes.c_float), ("rgb_scale", ctypes.c_float), ("damping", ctypes.c_float),
        ("drift", ctypes.c_float),
        ("dist_thresh", ctypes.c_float), ("angle_thresh", ctypes.c_float),
        ("min_grad2", ctypes.c_float), ("max_residual", ctypes.c_float),
        ("occlusion_thresh", ctypes.c_float),
        ("min_inliers", ctypes.c_float), ("step_tol", ctypes.c_float),
        ("carry_in", ctypes.c_void_p), ("carry_out", ctypes.c_void_p), ("fresh", ctypes.c_int),
        ("pre_out", ctypes.c_void_p), ("starved_out", ctypes.c_void_p),
        ("sums_out", ctypes.c_void_p), ("partials", ctypes.c_void_p), ("ticket", ctypes.c_void_p),
    ]


_launch = None  # the library's `track_iter_f32`, once loaded
_scratch_floats = 0
# (device index, stream handle) -> (partials, ticket), as `ops.gram` keeps them
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _declare(lib: ctypes.CDLL) -> None:
    lib.track_iter_f32.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.track_iter_f32.restype = ctypes.c_int
    lib.track_iter_scratch_floats.argtypes = []
    lib.track_iter_scratch_floats.restype = ctypes.c_int
    lib.track_iter_params_bytes.argtypes = []
    lib.track_iter_params_bytes.restype = ctypes.c_int


def _load():
    global _launch, _scratch_floats
    if _launch is None:
        lib = cuda_build.load("track_iter", _declare)
        if lib.track_iter_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"track_iter: Params is {lib.track_iter_params_bytes()} bytes in the library, "
                f"{ctypes.sizeof(_Params)} in its binding"
            )
        _scratch_floats = lib.track_iter_scratch_floats()
        _launch = lib.track_iter_f32
    return _launch


def _scratch(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pair = _SCRATCH.get((device.index, stream))
    if pair is None:
        pair = (
            torch.empty(_scratch_floats, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
        )
        _SCRATCH[(device.index, stream)] = pair
    return pair


def _check(name: str, t: torch.Tensor, *, whole: bool, numel: int = 0,
           dtype: torch.dtype = torch.float32, vector: bool = False) -> None:
    """Raise `ValueError` unless `t` has `dtype`, is contiguous (`whole`;
    otherwise a map read through its row and pixel strides, whose channels,
    if it has any, are adjacent), starts on a 16-byte boundary where the
    kernel reads it as float4 (`vector`), holds `numel` elements and lives
    on a CUDA device, in that order."""
    if t.dtype != dtype:
        raise ValueError(f"track_iter: {name} must be {dtype}, got {t.dtype}")
    if whole and not t.is_contiguous():
        raise ValueError(f"track_iter: {name} must be contiguous")
    if not whole and t.dim() == 3 and t.stride(-1) != 1:
        raise ValueError(f"track_iter: {name} must have a channel stride of 1")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"track_iter: {name} must start on a 16-byte boundary")
    if t.numel() < numel:
        raise ValueError(f"track_iter: {name} needs {numel} elements, has {t.numel()}")
    if t.device.type != "cuda":
        raise ValueError(f"track_iter: {name} is on {t.device}; the kernel runs on CUDA only")


def _run(mode: str, prm: _Params, rows: int, cols: int, frozen: bool, bilinear: bool,
         device: torch.device, n_sums: int) -> torch.Tensor:
    launch = _load()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    partials, ticket = _scratch(device, graphs.scratch_stream(device, stream))
    sums = torch.empty(n_sums, dtype=torch.float32, device=device)
    prm.sums_out, prm.partials, prm.ticket = sums.data_ptr(), partials.data_ptr(), ticket.data_ptr()
    err = launch(ctypes.byref(prm), int(mode.startswith("so3")), int(frozen), int(bilinear),
                 device.index, stream)
    if err != 0:
        raise RuntimeError(f"track_iter kernel launch failed: cudaError {err}")
    launches.add("gram", (rows, cols))
    launches.add("track_iter", mode)
    return sums


def _carry_args(prm: _Params, carry_in, carry_out, fresh: bool, size: int) -> None:
    _check("carry_in", carry_in, whole=True, numel=16 if fresh else size)
    _check("carry_out", carry_out, whole=True, numel=size)
    prm.carry_in, prm.carry_out, prm.fresh = carry_in.data_ptr(), carry_out.data_ptr(), int(fresh)


def _model_args(prm: _Params, pack: torch.Tensor, intr: CameraIntrinsics) -> None:
    _check("pack", pack, whole=True, vector=True)
    if pack.dim() != 3 or pack.shape[2] != 12:
        raise ValueError(f"track_iter: pack must be [H, W, 12], got {tuple(pack.shape)}")
    prm.pack, prm.Hm, prm.Wm = pack.data_ptr(), pack.shape[0], pack.shape[1]
    prm.fx, prm.fy, prm.cx, prm.cy = intr.fx, intr.fy, intr.cx, intr.cy


def _sample_args(prm: _Params, sample: Optional[torch.Tensor], write: bool, rows: int,
                 width: int) -> bool:
    if sample is None:
        if write:
            raise ValueError("track_iter: write_sample needs a sample buffer")
        return False
    _check("sample", sample, whole=True, numel=rows * width, vector=True)
    prm.sample, prm.write_sample = sample.data_ptr(), int(write)
    return not write


def gn_iteration(
    v_c: torch.Tensor,  # [h, w, 3] frame vertices (a strided view is fine)
    n_c: torch.Tensor,  # [h, w, 3]
    i_c: torch.Tensor,  # [h, w]
    pack: torch.Tensor,  # [Hm, Wm, 12] the level's packed model
    intr: CameraIntrinsics,  # the level's
    carry_in: torch.Tensor,
    carry_out: torch.Tensor,
    *,
    fresh: bool,
    bilinear: bool,
    icp_weight: float,
    rgb_scale: float,
    sample: Optional[torch.Tensor] = None,
    write_sample: bool = False,
    pre: Optional[torch.Tensor] = None,
    starved: Optional[torch.Tensor] = None,
    drift_px: float = reductions.GN_DRIFT_PX,
    damping: float = reductions.GN_DAMPING,
) -> torch.Tensor:
    """One Gauss-Newton iteration (`odometry._solve_iter` + `_advance` on the
    rows of `joint_rows_packed`, or of `joint_rows_frozen` where `sample` is
    read).  `fresh`: `carry_in` holds only the warm-start pose (the level's
    first iteration: the stats start at (inf, 0, inf, 0, I), `done` false).
    `pre` receives the carry the iteration started from and `starved` (a
    0-dim bool) ``~done & ~ok``.  Returns the [58] sums (`unpack_sums`)."""
    _check("v_c", v_c, whole=False)
    _check("n_c", n_c, whole=False)
    _check("i_c", i_c, whole=False)
    h, w = i_c.shape
    if v_c.shape != (h, w, 3) or n_c.shape != (h, w, 3):
        raise ValueError(f"track_iter: frame maps {tuple(v_c.shape)}, {tuple(n_c.shape)} "
                         f"do not match the intensity's {h}x{w} grid")
    prm = _Params()
    prm.vc, prm.vc_sy, prm.vc_sx = v_c.data_ptr(), v_c.stride(0), v_c.stride(1)
    prm.nc, prm.nc_sy, prm.nc_sx = n_c.data_ptr(), n_c.stride(0), n_c.stride(1)
    prm.ic, prm.ic_sy, prm.ic_sx = i_c.data_ptr(), i_c.stride(0), i_c.stride(1)
    prm.h, prm.w = h, w
    _model_args(prm, pack, intr)
    frozen = _sample_args(prm, sample, write_sample, h * w, GN_SAMPLE)
    _carry_args(prm, carry_in, carry_out, fresh, GN_CARRY)
    if pre is not None:
        _check("pre", pre, whole=True, numel=GN_CARRY)
        prm.pre_out = pre.data_ptr()
    if starved is not None:
        _check("starved", starved, whole=True, numel=1, dtype=torch.bool)
        prm.starved_out = starved.data_ptr()
    prm.w2 = icp_weight * icp_weight
    prm.rgb_scale, prm.damping, prm.drift = rgb_scale, damping, drift_px
    prm.dist_thresh = reductions.ICP_DIST_THRESH
    prm.angle_thresh = reductions.ICP_ANGLE_SIN_THRESH
    prm.min_grad2 = reductions.RGB_MIN_GRAD * reductions.RGB_MIN_GRAD
    prm.max_residual = reductions.RGB_MAX_RESIDUAL
    prm.occlusion_thresh = reductions.OCCLUSION_THRESH
    prm.min_inliers, prm.step_tol = reductions.GN_MIN_INLIERS, reductions.GN_STEP_TOL
    mode = "gn_frozen" if sample is not None else "gn_exact"
    return _run(mode, prm, h * w, 16, frozen, bilinear, pack.device, GN_SUMS)


def so3_iteration(
    i_c: torch.Tensor,  # [H, W] the coarsest level's intensity
    pack: torch.Tensor,
    intr: CameraIntrinsics,  # the coarsest level's
    carry_in: torch.Tensor,
    carry_out: torch.Tensor,
    *,
    fresh: bool,
    sample: Optional[torch.Tensor] = None,
    write_sample: bool = False,
    drift_px: float = reductions.SO3_DRIFT_PX,
    damping: float = reductions.SO3_DAMPING,
) -> torch.Tensor:
    """One iteration of `odometry._so3_prealign` (rows of `so3_rows_packed`,
    or of `so3_rows_frozen` where `sample` is read), with its rollback.
    `fresh`: `carry_in` holds only the warm-start pose.  Returns the [11]
    sums (`unpack_sums`)."""
    _check("i_c", i_c, whole=False)
    h, w = i_c.shape
    prm = _Params()
    prm.ic, prm.ic_sy, prm.ic_sx = i_c.data_ptr(), i_c.stride(0), i_c.stride(1)
    prm.h, prm.w = h, w
    _model_args(prm, pack, intr)
    frozen = _sample_args(prm, sample, write_sample, h * w, SO3_SAMPLE)
    _carry_args(prm, carry_in, carry_out, fresh, SO3_CARRY)
    prm.damping, prm.drift, prm.max_residual = damping, drift_px, reductions.RGB_MAX_RESIDUAL
    prm.min_inliers, prm.step_tol = reductions.SO3_MIN_INLIERS, reductions.SO3_STEP_TOL
    mode = "so3_frozen" if sample is not None else "so3_exact"
    return _run(mode, prm, h * w, 8, frozen, True, pack.device, SO3_SUMS)


def unpack_sums(sums: torch.Tensor):
    """The reduced sums as `reductions.GramStats` blocks: (ICP, RGB) for a GN
    iteration's [58], the one rotation block for an SO3 iteration's [11]
    (its Jtr is ``G[:3, 3]`` of the rows, its residual ``G[3, 3]``)."""
    def block(s: torch.Tensor, n: int) -> reductions.GramStats:
        iu = torch.triu_indices(n, n, device=s.device)
        JtJ = torch.zeros(n, n, dtype=s.dtype, device=s.device)
        k = n * (n + 1) // 2
        JtJ[iu[0], iu[1]] = s[:k]
        JtJ = JtJ + JtJ.T - torch.diag(torch.diagonal(JtJ))
        return reductions.GramStats(JtJ=JtJ, Jtr=s[k:k + n], residual_sq=s[k + n],
                                    inliers=s[k + n + 1])
    if sums.numel() == GN_SUMS:
        return block(sums[:_GN_BLOCK], 6), block(sums[_GN_BLOCK:], 6)
    return (block(sums, 3),)
