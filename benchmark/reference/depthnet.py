"""The depth CNN's forward pass, plain: the U-Net of the program's
`models/depthnet.py` (3x3 SAME convolution, GroupNorm, ELU per block; an
encoder block and a stride-2 block per width, a bottleneck, a decoder block
per width over the bilinearly upsampled input and the skip; a sigmoid
disparity head mapped to metric depth), its weights read from the packaged
npz file itself (flax '/' paths, HWIO kernels) and converted here."""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _block(x: torch.Tensor, p: Dict[str, torch.Tensor], k: int, stride: int) -> torch.Tensor:
    (t, b), (l, r) = (_same_pad(n, 3, stride) for n in x.shape[-2:])
    w = p[f"ConvBlock_{k}/Conv_0/kernel"]
    x = F.conv2d(F.pad(x, (l, r, t, b)), w, p[f"ConvBlock_{k}/Conv_0/bias"], stride=stride)
    c = w.shape[0]
    x = F.group_norm(x, min(8, c), p[f"ConvBlock_{k}/GroupNorm_0/scale"],
                     p[f"ConvBlock_{k}/GroupNorm_0/bias"], eps=1e-6)
    return F.elu(x)


class DepthNet:
    """rgb [1, 3, H, W] in [0, 1] -> metric depth [H, W]."""

    def __init__(self, params: Dict[str, torch.Tensor], widths: Sequence[int],
                 min_depth: float, max_depth: float):
        self.p, self.widths = params, tuple(widths)
        self.min_depth, self.max_depth = min_depth, max_depth

    @classmethod
    def from_files(cls, npz: Path, meta: Path, device) -> "DepthNet":
        m = json.loads(Path(meta).read_text())
        with np.load(npz) as z:
            raw = {k: z[k] for k in z.files}
        p = {}
        for k, v in raw.items():
            v = np.asarray(v, np.float32)
            if k.endswith("/kernel"):
                v = np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))  # HWIO -> OIHW
            p[k] = torch.from_numpy(v).to(device)
        return cls(p, m["widths"], m["min_depth"], m["max_depth"])

    def __call__(self, rgb_u8: torch.Tensor) -> torch.Tensor:
        x = rgb_u8.to(torch.float32).permute(2, 0, 1)[None] / 255.0
        n = len(self.widths)
        skips = []
        with torch.no_grad():
            for i in range(n):
                x = _block(x, self.p, 2 * i, 1)
                skips.append(x)
                x = _block(x, self.p, 2 * i + 1, 2)
            x = _block(x, self.p, 2 * n, 1)
            for i, s in enumerate(reversed(skips)):
                x = F.interpolate(x, size=s.shape[-2:], mode="bilinear", align_corners=False)
                x = _block(torch.cat([x, s], dim=1), self.p, 2 * n + 1 + i, 1)
            disp = torch.sigmoid(F.conv2d(x, self.p["Conv_0/kernel"], self.p["Conv_0/bias"],
                                          padding=1)[:, 0])
        lo, hi = 1.0 / self.max_depth, 1.0 / self.min_depth
        return (1.0 / (lo + (hi - lo) * disp))[0]
