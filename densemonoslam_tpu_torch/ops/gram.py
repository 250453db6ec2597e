"""Gram reduction ``G = M^T M`` (kernel K1): the normal-equation core of every
SO3 and Gauss-Newton iteration.

`gram(M)` is the one entry point the port uses.  A tensor on the CPU goes to
`gram_reference`, the plain PyTorch version; a CUDA tensor goes to the
hand-written Hopper kernel in `csrc/gram.cu` (replacing the TPU kernel
`densemonoslam_tpu.ops.pallas.gram.gram_pallas`), or the call raises.

The kernel is compiled with `nvcc` for `sm_90a` into `build/kernels/` at
first use, keyed by a hash of its source, and loaded through a plain C entry
point with `ctypes` (`ops.cuda_build`).  `LAUNCHES` counts kernel launches
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from densemonoslam_tpu_torch.ops import cuda_build

LAUNCHES = 0

SUPPORTED_COLS = (8, 16)


def gram_reference(M: torch.Tensor) -> torch.Tensor:
    """[P, C] -> [C, C] Gram matrix, plain PyTorch in f32."""
    return M.T @ M


def _declare(lib: ctypes.CDLL) -> None:
    lib.gram_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gram_f32.restype = ctypes.c_int
    lib.gram_rows_per_block.argtypes = []
    lib.gram_rows_per_block.restype = ctypes.c_int


def gram_cuda(M: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise)."""
    global LAUNCHES
    lib = cuda_build.load("gram", _declare)
    P, C = M.shape
    rows = lib.gram_rows_per_block()
    partials = torch.empty(((P + rows - 1) // rows, C, C), dtype=torch.float32, device=M.device)
    out = torch.empty((C, C), dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = lib.gram_f32(M.data_ptr(), partials.data_ptr(), out.data_ptr(), P, C, stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def gram(M: torch.Tensor) -> torch.Tensor:
    """[P, C] masked rows -> [C, C] Gram matrix in f32.

    CPU tensors use `gram_reference`; CUDA tensors use the kernel (never a
    fallback).  Raises unless M is 2-D, f32, contiguous, with C in (8, 16)."""
    if M.dim() != 2 or M.dtype != torch.float32 or not M.is_contiguous():
        raise ValueError(
            f"gram needs a contiguous 2-D float32 tensor, got {M.dtype} {tuple(M.shape)}"
        )
    if M.shape[1] not in SUPPORTED_COLS:
        raise ValueError(f"gram supports C in {SUPPORTED_COLS}, got C={M.shape[1]}")
    if M.shape[0] >= 2**31:
        raise ValueError(f"gram supports fewer than 2^31 rows, got {M.shape[0]}")
    if M.device.type == "cuda":
        return gram_cuda(M)
    if M.device.type == "cpu":
        return gram_reference(M)
    raise ValueError(f"gram has no kernel for device {M.device}")
