"""``ba_pose_gap``: the sparse tracker's local bundle adjustments in the
window, the flush stage that writes refined keyframe poses back.  The
probe wraps the camera's tracker's `_adv_ba_apply` (the flush stage that
reads a solve and applies it) and keeps, for every solve of the window,
the window's keyframe ticks, the poses the solve started from and the
poses it returned (a clone on the card, no wait).  After the window,
``solves`` of them are drawn from the seed; the reference detects each
keyframe's keypoints again from its frame with its own CNN's depth,
matches them, builds the tracks and solves by itself
(`reference.mono.ba_readings`).  Parameters: ``solves``."""

from __future__ import annotations

import numpy as np

from checks import mono_base
from checks.base import Check as _Base
from reference import mono


class Check(_Base):
    def before_window(self) -> None:
        ctx = self.ctx
        tr = ctx.frontend.sparse_tracker
        self.tracker, inner = tr, tr._adv_ba_apply
        self.caps = []

        def apply(p):
            if ctx.in_window:
                self.caps.append({
                    "ticks": [int(tr.keyframes[p["base"] + i][2]) for i in range(p["W"])],
                    "poses_in": np.array(p["poses_in"], np.float32),
                    "out": p["out"].detach().clone(),
                })
            return inner(p)

        tr._adv_ba_apply = apply

    def after_window(self) -> None:
        del self.tracker._adv_ba_apply  # the class's method again
        ctx = self.ctx
        rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 7])
        n = min(int(self.params["solves"]), len(self.caps))
        pick = sorted(int(i) for i in rng.choice(len(self.caps), n, replace=False)) if n else []
        self.samples = []
        for i in pick:
            cap = self.caps[i]
            self.samples.append({"rgbs": [ctx.traffic.frame(t)[0] for t in cap["ticks"]],
                                 "poses_in": cap["poses_in"], "out": cap["out"].cpu().numpy()})
        self.caps = []

    def readings(self, control: bool = False):
        return mono.ba_readings(self.ctx.config, mono_base.reference_net(self.ctx), self.samples,
                                self.ctx.device, control=control)
