"""Gram reduction ``G = M^T M`` (kernel K1): the normal-equation core of every
SO3 and Gauss-Newton iteration.

`gram(M)` is the one entry point the port uses.  A tensor on the CPU goes to
`gram_reference`, the plain PyTorch version; a CUDA tensor goes to the
hand-written Hopper kernel in `csrc/gram.cu` (replacing the TPU kernel
`densemonoslam_tpu.ops.pallas.gram.gram_pallas`), or the call raises.

The kernel is compiled with `nvcc` for `sm_90a` into `build/kernels/` at
first use, keyed by a hash of its source, and loaded through a plain C entry
point with `ctypes`.  `LAUNCHES` counts kernel launches so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

LAUNCHES = 0

SUPPORTED_COLS = (8, 16)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "gram.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_lib = None


def gram_reference(M: torch.Tensor) -> torch.Tensor:
    """[P, C] -> [C, C] Gram matrix, plain PyTorch in f32."""
    return M.T @ M


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile `csrc/gram.cu` unless a library for this exact source exists;
    return the library's path.  Raises if the build fails."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libgram_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gram_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gram_f32.restype = ctypes.c_int
        lib.gram_rows_per_block.argtypes = []
        lib.gram_rows_per_block.restype = ctypes.c_int
        _lib = lib
    return _lib


def gram_cuda(M: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise)."""
    global LAUNCHES
    lib = _load()
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
