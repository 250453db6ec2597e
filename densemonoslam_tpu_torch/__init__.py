"""PyTorch/CUDA port of `densemonoslam_tpu` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference: every module here keeps
its counterpart's public names, argument order and array layouts (maps
`[H,W,3]`, the surfel table `[N+1,16]`, the 29-float stats vector), and the
parity tests under `tests/test_torch_*.py` feed both the same numpy inputs.
This package never imports jax or `densemonoslam_tpu`.

Ported so far: the single-camera RGB-D path (`engine.Engine` ->
`step.make_step`), open or closed loop (ferns, local loop closure through
the deformation graph), with relocalisation, and the monocular hybrid stack
(the depth CNN `models.depthnet`, the sparse tracker `tracking.sparse` with
the BA and PGO solvers of `parallel.ba`, hybrid loops), several cameras in
one engine and the `torch.distributed` collaborative session (`parallel`),
and the application layer: the command line `python -m
densemonoslam_tpu_torch.cli`, `.klg` / dataset / UDP input (`io`), camera
managers, checkpoints (`utils.checkpoint`), the `Stopwatch` and the web
viewer (`viewer`).  Both TPU kernels are hand-written CUDA kernels: the
Gram reduction (`csrc/gram.cu`, wrapped by `ops.gram`) and the whole-map
deformation (`csrc/deform.cu`, `ops.deform`).
Entry points run on the card unless the caller asks for the CPU.
"""

import torch as _torch

# SLAM is a geometry pipeline: poses chain multiplicatively and the GN normal
# equations difference near-equal quantities, so reduced-precision matmuls
# spoil it (the JAX package measured 59 mm ATE with them against 0.7 mm in
# full f32, `densemonoslam_tpu/__init__.py`).  TF32 keeps ~10 mantissa bits:
# keep every matmul and convolution in true f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from densemonoslam_tpu_torch.config import (  # noqa: E402
    CameraIntrinsics,
    EngineConfig,
    FrameResolution,
)

__version__ = "0.1.0"

__all__ = [
    "CameraIntrinsics",
    "EngineConfig",
    "FrameResolution",
    "__version__",
]
