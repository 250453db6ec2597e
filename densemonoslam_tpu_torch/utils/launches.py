"""Kernel launch counts: one `Counter` keyed ``(kernel, shape)``.

Each hand-written kernel's wrapper adds one where it launches its kernel
(`ops.gram` keys K1 by ``(P, C)``; `ops.deform`, `csrc/graph_if.cu`'s
condition setter and `csrc/stamp.cu`'s stage stamp by ``None``), so that a run can show that its main path
went through the kernels.  A CUDA graph's replays add the launches its
capture recorded (`utils.graphs`), which only needs this module: the graph
helper knows no kernel.
"""

from __future__ import annotations

from collections import Counter
from typing import Hashable

COUNTS: Counter = Counter()


def add(kernel: str, shape: Hashable = None, n: int = 1) -> None:
    COUNTS[(kernel, shape)] += n


def total(kernel: str) -> int:
    """Launches of `kernel` at every shape."""
    return sum(n for (k, _), n in COUNTS.items() if k == kernel)


def by_shape(kernel: str) -> Counter:
    """Launches of `kernel` per shape."""
    return Counter({s: n for (k, s), n in COUNTS.items() if k == kernel and n})


def reset() -> None:
    """Set every count to 0."""
    COUNTS.clear()
