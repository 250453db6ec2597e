"""The shape every check has (see the package's docstring), and how a
check draws the window frames it looks at."""

from __future__ import annotations

from typing import Dict

import numpy as np

LAST_SHARE = 0.97  # sample times fall before this share of the window


class Sampler:
    """Window frames drawn from the seed by time: `n` times drawn uniformly
    over the window (`ctx.seconds`) up to `last_share` of it, and for each
    the first frame handed over at or after it, so that every part of the
    window is drawn alike.  Frames inside a traced span are never drawn (the probes
    would be traced): a time that falls there takes the first frame after
    it.  Times that fall on one frame draw it once."""

    def __init__(self, ctx, n: int, salt: int, last_share: float = LAST_SHARE):
        self.ctx = ctx
        rng = np.random.default_rng([int(ctx.seed) % (1 << 64), salt])
        self.times = sorted(float(t) for t in rng.uniform(0.0, last_share * ctx.seconds, int(n)))

    def take(self) -> bool:
        """Whether the frame about to be handed over is drawn."""
        ctx = self.ctx
        if ctx.in_span or not self.times or ctx.t_window < self.times[0]:
            return False
        while self.times and self.times[0] <= ctx.t_window:
            self.times.pop(0)
        return True


class Check:
    def __init__(self, ctx, params: dict):
        self.ctx = ctx
        self.params = params

    def after_setup_frame(self, j: int) -> None:
        """Set-up frame `j` (0-based) has been handed over."""

    def before_window(self) -> None:
        """The window is about to open."""

    def before_frame(self, j: int) -> None:
        """Window frame `j` is about to be handed over."""

    def after_window(self) -> None:
        """The window has closed and the card is idle; the program's state
        is still there.  Keep what `readings` needs on the host."""

    def readings(self, control: bool = False) -> Dict[str, float]:
        """Gaps of the program (or, with `control`, of the reference in
        TF32) from the reference; runs after the program's state is freed."""
        raise NotImplementedError
