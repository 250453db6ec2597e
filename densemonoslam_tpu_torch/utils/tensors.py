"""Small tensor helpers for code that must not synchronise the device."""

from __future__ import annotations

import torch


def scalar(value, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """`value` as a 0-dim tensor of `dtype` on `device`.

    A Python number is written by a fill kernel: `torch.tensor(x,
    device="cuda")` copies from pageable host memory, which synchronises
    the stream and stalls the host every time."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)
