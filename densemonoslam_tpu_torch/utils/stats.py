"""Per-frame session statistics.

Equivalent of the reference's `Core/src/Utils/Stats.h` (per-frame NID scores,
surfel counts, fusion flags, written as `.stats` text at session end via
`ElasticFusion.cpp:634`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class SessionStats:
    nid_scores: List[float] = field(default_factory=list)
    surfel_counts: List[int] = field(default_factory=list)
    fused_flags: List[bool] = field(default_factory=list)
    frames_fused: int = 0
    frames_processed: int = 0
    deforms: int = 0
    fern_deforms: int = 0
    keyframes: int = 0

    def record(self, nid_score: float, surfel_count: int, fused: bool) -> None:
        self.nid_scores.append(float(nid_score))
        self.surfel_counts.append(int(surfel_count))
        self.fused_flags.append(bool(fused))
        self.frames_processed += 1
        if fused:
            self.frames_fused += 1

    def write(self, path: str) -> None:
        """Text layout: one line per frame `frame nid surfels fused`, then a
        summary block — same information as the reference `.stats` file."""
        with open(path, "w") as f:
            for i, (nid, n, fused) in enumerate(
                zip(self.nid_scores, self.surfel_counts, self.fused_flags)
            ):
                f.write(f"{i} {nid:.6f} {n} {int(fused)}\n")
            f.write(
                f"# processed={self.frames_processed} fused={self.frames_fused} "
                f"deforms={self.deforms} fernDeforms={self.fern_deforms} "
                f"keyframes={self.keyframes}\n"
            )
