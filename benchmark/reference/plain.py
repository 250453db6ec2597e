"""Plain stand-ins for the program's device machinery: a branch is a Python
`if` on its predicate, a branch's results are copied into place, and the
Gram reduction (kernel K1 in the program) is one matrix product."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def branch(pred: torch.Tensor, body: Callable[[], None], name: str) -> None:
    """Run `body` where the 0-dim bool `pred` holds (a host read)."""
    if bool(pred):
        body()


def assign(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """Copy each of `srcs` into the tensor at its place in `dsts`."""
    for d, s in zip(dsts, srcs):
        d.copy_(s)


def gram(M: torch.Tensor) -> torch.Tensor:
    """``M^T M`` of a `[P, C]` block: float32, in TF32 only where the caller
    allows TF32 matmuls."""
    return M.T @ M
