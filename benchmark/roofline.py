"""The yardstick's arithmetic: the H100's peaks, and the bytes and
operations of each kernel's work, counted from the shapes of the work
whatever kernel does it.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense,
no sparsity): HBM 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s
(the port turns TF32 off, `densemonoslam_tpu_torch/__init__.py`).  A
bound is the larger of bytes / bandwidth and operations / peak: the least
time the card could take.  Each input byte is counted read once and each
output byte written once.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# K2: each row below the count reads its position, confidence, normal and
# initialisation time (8 floats); each live row writes its position and
# normal (6 floats); each node is read once (its 3x3, translation, position
# and time: 17 floats); 330 operations a live row (20 candidates x 8, the
# 4 nearest's weights, the blend and the apply)
K2_READ_ROW, K2_WRITE_ROW, K2_NODE, K2_FLOP_ROW = 32.0, 24.0, 68.0, 330.0


def bound_s(n_bytes: float, n_flop: float) -> float:
    return max(n_bytes / PEAK_BYTES_S, n_flop / PEAK_F32_S)


def gram_work(P: int, C: int) -> Tuple[float, float]:
    """K1, ``G = M^T M`` of an f32 [P, C] block: (bytes, operations)."""
    return 4.0 * (P * C + C * C), 2.0 * P * C * C


def deform_work(n_rows: int, n_live: int, n_nodes: int) -> Tuple[float, float]:
    """K2 over a map with `n_rows` rows below its count, `n_live` of them
    live, and `n_nodes` graph nodes: (bytes, operations)."""
    return (K2_READ_ROW * n_rows + K2_WRITE_ROW * n_live + K2_NODE * n_nodes,
            K2_FLOP_ROW * n_live)


def depthnet_flop(height: int, width: int, widths: Sequence[int] = (32, 64, 128, 256)) -> float:
    """Operations (2 per multiply-add) of one forward pass of the depth
    CNN's U-Net on one [3, height, width] image: per width a 3x3 conv and a
    stride-2 3x3 conv, a bottleneck conv, per width a decoder conv over the
    upsampled input and the skip, and the 1-channel head."""
    tot, c, h, w = 0.0, 3, height, width
    skips = []
    for wd in widths:
        tot += 2.0 * c * 9 * wd * h * w
        skips.append((h, w))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
        tot += 2.0 * wd * 9 * wd * h * w
        c = wd
    tot += 2.0 * c * 9 * widths[-1] * h * w
    c = widths[-1]
    for wd, (h, w) in zip(reversed(widths), reversed(skips)):
        tot += 2.0 * (c + wd) * 9 * wd * h * w
        c = wd
    return tot + 2.0 * c * 9 * height * width
