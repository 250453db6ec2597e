"""PyTorch/CUDA port of `densemonoslam_tpu` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference: every module here keeps
its counterpart's public names, argument order and array layouts (maps
`[H,W,3]`, the surfel table `[N+1,16]`, the 29-float stats vector), and the
parity tests under `tests/test_torch_*.py` feed both the same numpy inputs.
This package never imports jax or `densemonoslam_tpu`.

Ported so far: the open-loop single-camera RGB-D path (`engine.Engine` ->
`step.make_step`), with the Gram reduction as a hand-written CUDA kernel
(`csrc/gram.cu`, wrapped by `ops.gram`).
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
