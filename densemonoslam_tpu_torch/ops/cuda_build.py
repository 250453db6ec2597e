"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled with `nvcc` for `sm_90a` into a shared library with
a plain C interface under `build/kernels/`, named after the source and a
hash of its bytes and the compiler flags, so an edited source is rebuilt
and an unchanged one is reused.  Libraries are loaded with `ctypes`.

Nothing here runs at import time: a kernel is built at its first use (or
by `build(...)`, which starts one `nvcc` per missing library, all at once).
`kernels_per_call` counts the device operations one call of a wrapper
enqueues, for the checks that a call launches what it should and no more.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# flags one source adds to NVCC_FLAGS: the fused tracking iteration builds
# its rows, and the full-map render its projections, without FMA
# contraction, so they round as the op-by-op composition's elementwise
# operations do
SOURCE_FLAGS = {"track_iter": ["--fmad=false"], "zbuffer": ["--fmad=false"]}
_LOADED: Dict[str, ctypes.CDLL] = {}
# nvcc processes started: a run reads it to show that no kernel was built
# inside its timed frames
BUILDS = 0


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


def _flags(name: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` at its current source lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name.replace('/', '-')}_{key}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile `csrc/<name>.cu` for each name whose library is missing, one
    `nvcc` process per source, all started together; return each name's
    library path.  Raises if any build fails."""
    global BUILDS
    libs = {name: _library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILDS += len(todo)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for name, (tmp, cmd, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            else:
                # atomic: a concurrent build never loads a partial file
                os.replace(tmp, todo[name])
    finally:
        for tmp, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built first if needed);
    `declare` sets its functions' `argtypes`/`restype` on the first load."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        declare(lib)
        _LOADED[name] = lib
    return lib


def kernels_per_call(fn) -> tuple[int, int]:
    """(kernels, all device operations) that one call of `fn` enqueues on
    the current CUDA device, counted from a CUDA graph of the call (a
    profiler window can lose device events).  The call runs once on the
    capture stream first, so what a wrapper keeps per stream (K1's scratch
    and ticket) exists before the capture."""
    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"CUDA driver call failed: CUresult {err}")

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(stream):
        graph.capture_begin()
        fn()
        graph.capture_end()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kinds.append(kind.value)
    graph.reset()
    return sum(kind == 0 for kind in kinds), len(kinds)  # 0: CU_GRAPH_NODE_TYPE_KERNEL
