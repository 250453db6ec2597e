"""Monocular depth prediction network (port of `densemonoslam_tpu.models.
depthnet`): inference and supervised training.

A compact U-Net (strided conv encoder, skip-connected decoder) emits a
disparity map through a sigmoid, turned into metric depth with the
monodepth convention ``depth = 1 / (min_disp + (max_disp - min_disp) * s)``.
The layers reproduce flax's: 3x3 convolutions with `SAME` padding (which is
asymmetric for a stride-2 convolution on an even size: nothing before, one
row/column after), GroupNorm with `min(8, features)` groups and epsilon 1e-6,
ELU, and a bilinear upsampling to each skip's exact size.  The network runs
NCHW inside; `DepthPredictor.predict` keeps the reference's interface,
``[H, W, 3] u8 -> [H, W] f32`` metric depth.

Parameters start as flax's do (`DepthNet(seed=...)`): LeCun-normal
convolution kernels (a normal cut at +-2 sigma, variance 1/fan_in), zero
biases, GroupNorm scale 1 and bias 0.  `l1_depth_loss` and
`make_train_step` are the JAX package's training path; `torch.optim.Adam`
with betas (0.9, 0.999) and eps 1e-8 stands for `optax.adam`.

The packaged weights (`weights/depthnet_{synthetic,street}.{npz,json}`) are
byte-for-byte copies of the JAX package's files.  Weight files hold the JAX
package's keys (`params_to_flax` / `params_from_flax`), so a file either
package writes loads into the other.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from densemonoslam_tpu_torch.models.onnx_import import flax_conv_to_torch, torch_conv_to_flax

WEIGHTS_DIR = Path(__file__).resolve().parent / "weights"


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of flax/XLA `SAME` along one axis of size n."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """3x3 conv (SAME) -> GroupNorm -> ELU."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.utils.skip_init(nn.Conv2d, in_features, features, 3, stride=stride)
        self.norm = nn.GroupNorm(min(8, features), features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = (_same_pad(n, 3, self.stride) for n in x.shape[-2:])
        x = self.conv(F.pad(x, (l, r, t, b)))
        return F.elu(self.norm(x))


class DepthNet(nn.Module):
    """U-Net depth predictor: rgb [B,3,H,W] in [0,1] -> metric depth [B,H,W].

    Blocks are numbered in flax's creation order: for each width an encoder
    block and its stride-2 block, the bottleneck, then one decoder block per
    width, coarsest first; `head` is the final 1-channel convolution.  The
    parameters are initialised as flax initialises them, from a generator
    seeded with `seed` (`init_like_flax`)."""

    def __init__(
        self, widths: Sequence[int] = (32, 64, 128, 256), min_depth: float = 0.5,
        max_depth: float = 80.0, seed: int = 0,
    ):
        super().__init__()
        self.widths = tuple(widths)
        self.min_depth, self.max_depth = min_depth, max_depth
        blocks, c = [], 3
        for w in self.widths:
            blocks += [ConvBlock(c, w), ConvBlock(w, w, stride=2)]
            c = w
        blocks.append(ConvBlock(c, self.widths[-1]))
        c = self.widths[-1]
        for w in reversed(self.widths):
            blocks.append(ConvBlock(c + w, w))
            c = w
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.utils.skip_init(nn.Conv2d, c, 1, 3, padding=1)
        init_like_flax(self, torch.Generator().manual_seed(seed))

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        n = len(self.widths)
        skips = []
        x = rgb
        for i in range(n):
            x = self.blocks[2 * i](x)
            skips.append(x)
            x = self.blocks[2 * i + 1](x)
        x = self.blocks[2 * n](x)
        for i, s in enumerate(reversed(skips)):
            x = F.interpolate(x, size=s.shape[-2:], mode="bilinear", align_corners=False)
            x = self.blocks[2 * n + 1 + i](torch.cat([x, s], dim=1))
        disp = torch.sigmoid(self.head(x)[:, 0])
        min_disp, max_disp = 1.0 / self.max_depth, 1.0 / self.min_depth
        return 1.0 / (min_disp + (max_disp - min_disp) * disp)


@torch.no_grad()
def init_like_flax(net: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisation of `net`'s layers, drawn from `generator`:
    every convolution kernel from `nn.initializers.lecun_normal()` (a normal
    truncated at +-2 sigma and rescaled by 1/0.87962566 so that its variance
    is 1/fan_in, fan_in = in_channels x 3 x 3), biases 0, GroupNorm scale 1
    and bias 0.  torch's own defaults (kaiming-uniform, variance
    1/(3 fan_in), nonzero biases) start training elsewhere."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def l1_depth_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Masked L1 + gradient matching on [B, H, W] depths (the JAX package's
    expression): the mean |pred - gt| over pixels with gt > 0 (the count
    floored at 1), plus half the mean |d pred| - |d gt| mismatch along x and
    along y."""
    valid = gt > 0
    l1 = (pred - gt).abs() * valid
    gx_p = (pred[:, :, 1:] - pred[:, :, :-1]).abs()
    gx_g = (gt[:, :, 1:] - gt[:, :, :-1]).abs()
    gy_p = (pred[:, 1:] - pred[:, :-1]).abs()
    gy_g = (gt[:, 1:] - gt[:, :-1]).abs()
    grad = (gx_p - gx_g).abs().mean() + (gy_p - gy_g).abs().mean()
    return l1.sum() / valid.sum().clamp(min=1) + 0.5 * grad


def make_train_step(net: DepthNet, optimizer: torch.optim.Optimizer):
    """Supervised training step (for distillation / RGB-D fitting):
    ``step(rgb, depth_gt) -> loss`` with `rgb` [B, H, W, 3] f32 in [0, 1]
    (the JAX layout; permuted to NCHW here) and `depth_gt` [B, H, W] on
    `net`'s device.  It updates `net`'s parameters and `optimizer`'s state
    in place and returns the loss as a 0-dim device tensor: nothing in the
    step reads the device from the host.

    Training stays in true f32 and does not opt into TF32: the package
    turns TF32 off for matmuls and cuDNN convolutions, as the JAX package
    trains at `jax_default_matmul_precision="highest"`."""

    def step(rgb: torch.Tensor, depth_gt: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = l1_depth_loss(net(rgb.permute(0, 3, 1, 2)), depth_gt)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def params_from_flax(flax_params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, flattened with '/' paths as its npz
    files hold them (`ConvBlock_k/Conv_0/kernel` HWIO, `.../bias`,
    `ConvBlock_k/GroupNorm_0/scale|bias`, `Conv_0/kernel|bias`), as a state
    dict of `DepthNet`."""
    out = {}
    for path, arr in flax_params.items():
        arr = np.asarray(arr, np.float32)
        parts = path.split("/")
        if parts[0].startswith("ConvBlock_"):
            k = int(parts[0].split("_")[1])
            sub = "conv" if parts[1].startswith("Conv") else "norm"
            prefix = f"blocks.{k}.{sub}"
        elif parts[0] == "Conv_0":
            prefix = "head"
        else:
            raise KeyError(f"unknown parameter {path}")
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[parts[-1]]
        if parts[-1] == "kernel":
            arr = flax_conv_to_torch(arr)
        out[f"{prefix}.{leaf}"] = torch.from_numpy(arr)
    return out


# (layer, parameter) of a `ConvBlock` or of `head` -> its flax path's tail
_FLAX_LEAF = {("conv", "weight"): "Conv_0/kernel", ("conv", "bias"): "Conv_0/bias",
              ("norm", "weight"): "GroupNorm_0/scale", ("norm", "bias"): "GroupNorm_0/bias"}


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_flax`: a `DepthNet` state dict as the
    JAX package's '/'-path parameters (conv kernels OIHW -> HWIO)."""
    out = {}
    for name, v in state.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            key = f"ConvBlock_{int(parts[1])}/{_FLAX_LEAF[tuple(parts[2:])]}"
        elif parts[0] == "head":
            key = _FLAX_LEAF[("conv", parts[1])]
        else:
            raise KeyError(f"unknown parameter {name}")
        arr = v.detach().cpu().numpy()
        out[key] = torch_conv_to_flax(arr) if key.endswith("/kernel") else arr
    return out


def read_params(path) -> Dict[str, torch.Tensor]:
    """A `DepthNet` state dict from an npz with the JAX package's '/' keys
    (what both packages write) or with this module's parameter names."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    if any("/" in k for k in d):
        return params_from_flax(d)
    return {k: torch.from_numpy(v) for k, v in d.items()}


class DepthPredictor:
    """Engine-facing wrapper (the reference `DepthPrediction` class): u8 RGB
    frame in, metric f32 depth out, on the card unless `device` says
    otherwise.

    `compute_dtype` (e.g. torch.bfloat16) casts the parameters and the input
    for the forward pass; the output comes back in f32.  The default, None,
    runs in f32."""

    def __init__(
        self,
        params: Optional[Dict[str, torch.Tensor]] = None,
        widths: Sequence[int] = (32, 64, 128, 256),
        min_depth: float = 0.5,
        max_depth: float = 80.0,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        device: torch.device | str = "cuda",
    ):
        self.net = DepthNet(widths=widths, min_depth=min_depth, max_depth=max_depth, seed=seed)
        if params is not None:
            self.net.load_state_dict(params)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DepthPredictor runs on the card by default and no CUDA device is "
                'available: pass device="cpu" to run on the CPU'
            )
        self.net = self.net.to(self.device).eval()
        self._compute_dtype = compute_dtype
        self._net_lp: Optional[DepthNet] = None  # the reduced-precision copy

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def predict(self, rgb_u8) -> torch.Tensor:
        """[H,W,3] u8 (numpy or tensor) -> [H,W] metric depth on `device`."""
        x = torch.as_tensor(rgb_u8, device=self.device).to(torch.float32)
        x = x.permute(2, 0, 1)[None] / 255.0
        net = self.net
        if self._compute_dtype is not None:
            if self._net_lp is None:
                self._net_lp = copy.deepcopy(self.net).to(self._compute_dtype)
            net, x = self._net_lp, x.to(self._compute_dtype)
        with torch.no_grad():
            return net(x)[0].to(torch.float32)

    @classmethod
    def _packaged(cls, name: str, device, compute_dtype) -> "DepthPredictor":
        import json

        meta = json.loads((WEIGHTS_DIR / f"depthnet_{name}.json").read_text())
        return cls(
            params=read_params(WEIGHTS_DIR / f"depthnet_{name}.npz"),
            widths=tuple(meta["widths"]), min_depth=meta["min_depth"],
            max_depth=meta["max_depth"], compute_dtype=compute_dtype, device=device,
        )

    @classmethod
    def pretrained_synthetic(
        cls, device: torch.device | str = "cuda", compute_dtype=None
    ) -> "DepthPredictor":
        """The packaged weights distilled from the analytic synthetic scene
        (`depthnet_synthetic.npz`)."""
        return cls._packaged("synthetic", device, compute_dtype)

    @classmethod
    def pretrained_street(
        cls, device: torch.device | str = "cuda", compute_dtype=None
    ) -> "DepthPredictor":
        """The packaged weights trained on the street-scale procedural loop
        (`depthnet_street.npz`), the monocular KITTI-shaped operating point."""
        return cls._packaged("street", device, compute_dtype)

    # --- weight I/O --------------------------------------------------------
    def save(self, path: str) -> None:
        """The parameters as an npz with the JAX package's keys and layouts
        (`params_to_flax`): the JAX `DepthPredictor.load` reads it."""
        np.savez_compressed(path, **params_to_flax(self.params))

    def load(self, path: str) -> None:
        """Load an npz written by `save` or by the JAX package (`read_params`)."""
        self.net.load_state_dict(read_params(path))
        self._net_lp = None
