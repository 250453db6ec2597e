"""``depth_gap``: the depth CNN's output for window frames drawn from the
seed by time (`base.Sampler`).  The probe wraps the attached predictor's
`predict`; for a drawn frame its output is copied into a pinned host
buffer behind the frame's work, without a wait.  The reference predicts the frame again
(`reference.mono.depth_readings`).  Parameters: ``frames``."""

from __future__ import annotations

import torch

from checks import mono_base
from checks.base import Check as _Base, Sampler
from reference import mono


class Check(_Base):
    def before_window(self) -> None:
        ctx = self.ctx
        self.sampler = Sampler(ctx, int(self.params["frames"]), salt=5)
        self.out = {}
        self.current = None
        pred = ctx.engine._depth_predictor
        self.pred, inner = pred, pred.predict

        def predict(rgb):
            depth = inner(rgb)
            if self.current is not None:
                buf = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=ctx.on_card)
                buf.copy_(depth, non_blocking=True)
                self.out[self.current] = buf
            return depth

        pred.predict = predict

    def before_frame(self, j: int) -> None:
        self.current = j if self.sampler.take() else None

    def after_window(self) -> None:
        del self.pred.predict  # the class's method again
        ctx = self.ctx
        self.samples = [{"rgb": ctx.traffic.frame(ctx.traffic.warmup + j)[0], "depth": d}
                        for j, d in sorted(self.out.items())]

    def readings(self, control: bool = False):
        return mono.depth_readings(mono_base.reference_net(self.ctx), self.samples,
                                   self.ctx.device, control=control)
