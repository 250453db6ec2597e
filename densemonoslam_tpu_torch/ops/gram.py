"""Gram reduction ``G = M^T M`` (kernel K1): the normal-equation core of every
SO3 and Gauss-Newton iteration.

`gram(M)` is the entry point for a row matrix.  A tensor on the CPU goes to
`gram_reference`, the plain PyTorch version; a CUDA tensor goes to the
hand-written Hopper kernel in `csrc/gram.cu` (replacing the TPU kernel
`densemonoslam_tpu.ops.pallas.gram.gram_pallas`), or the call raises.  On
the card `odometry.track` does not build M: it runs K1 fused into the whole
tracking iteration (`ops.track_iter`).

The kernel is compiled with `nvcc` for `sm_90a` into `build/kernels/` at
first use, keyed by a hash of its source, and loaded through a plain C entry
point with `ctypes` (`ops.cuda_build`).  One call is one launch: the entry
point, and each stream's scratch and ticket, are looked up once and kept.
Inside a CUDA graph capture the scratch is the capture stream's, allocated
by the warm-up before it (`utils.graphs.scratch_stream`).  Each launch
adds one to `utils.launches` under ``("gram", (P, C))``, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from densemonoslam_tpu_torch.ops import cuda_build
from densemonoslam_tpu_torch.utils import graphs, launches

SUPPORTED_COLS = (8, 16)

_launch = None  # the library's `gram_f32`, once loaded
_scratch_floats = 0
# (device index, stream handle) -> (partials, ticket): the kernel's last
# block resets the ticket, so a stream reuses its pair from call to call
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def gram_reference(M: torch.Tensor) -> torch.Tensor:
    """[P, C] -> [C, C] Gram matrix, plain PyTorch in f32."""
    return M.T @ M


def _declare(lib: ctypes.CDLL) -> None:
    lib.gram_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gram_f32.restype = ctypes.c_int
    lib.gram_scratch_floats.argtypes = []
    lib.gram_scratch_floats.restype = ctypes.c_int


def _scratch(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pair = _SCRATCH.get((device.index, stream))
    if pair is None:
        pair = (
            torch.empty(_scratch_floats, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
        )
        _SCRATCH[(device.index, stream)] = pair
    return pair


def gram_cuda(M: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise)."""
    global _launch, _scratch_floats
    if M.data_ptr() % 16:
        raise ValueError("gram needs a 16-byte aligned M for its bulk copies")
    if _launch is None:
        lib = cuda_build.load("gram", _declare)
        _scratch_floats = lib.gram_scratch_floats()
        _launch = lib.gram_f32
    P, C = M.shape
    dev = M.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    partials, ticket = _scratch(dev, graphs.scratch_stream(dev, stream))
    out = torch.empty((C, C), dtype=torch.float32, device=dev)
    err = _launch(M.data_ptr(), P, C, partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                  dev.index, stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: cudaError {err}")
    launches.add("gram", (P, C))
    return out


def gram(M: torch.Tensor) -> torch.Tensor:
    """[P, C] masked rows -> [C, C] Gram matrix in f32.

    CPU tensors use `gram_reference`; CUDA tensors use the kernel (never a
    fallback).  Raises unless M is 2-D, f32, contiguous, with C in (8, 16);
    on the card M must also start on a 16-byte boundary."""
    if M.dim() != 2 or M.dtype != torch.float32 or not M.is_contiguous():
        raise ValueError(
            f"gram needs a contiguous 2-D float32 tensor, got {M.dtype} {tuple(M.shape)}"
        )
    if M.shape[1] not in SUPPORTED_COLS:
        raise ValueError(f"gram supports C in {SUPPORTED_COLS}, got C={M.shape[1]}")
    if M.device.type == "cuda":
        return gram_cuda(M)
    if M.device.type == "cpu":
        return gram_reference(M)
    raise ValueError(f"gram has no kernel for device {M.device}")
