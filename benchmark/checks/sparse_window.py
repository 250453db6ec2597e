"""``sparse_pose_gap``: the sparse tracker's pose for window frames drawn
from the seed by time (`base.Sampler`).  The probe wraps the camera's
tracker's `track`; for a drawn frame it clones, on the card and without a
wait, the tracker's previous keypoints and pose and its current pose
before the call and the pose it returns.  The reference works the pose
out again from that state with its own depth
(`reference.mono.sparse_readings`).  Parameters: ``frames``."""

from __future__ import annotations

from checks import mono_base
from checks.base import Check as _Base, Sampler
from reference import mono


def _clone(x):
    return x.detach().clone()


class Check(_Base):
    def before_window(self) -> None:
        ctx = self.ctx
        self.sampler = Sampler(ctx, int(self.params["frames"]), salt=6)
        self.caps = {}
        self.current = None
        tr = ctx.frontend.sparse_tracker
        self.tracker, inner = tr, tr.track

        def track(intensity, depth):
            cap = None
            if self.current is not None and tr._prev is not None:
                kp, prev_pose = tr._prev
                cap = {"prev_kp": tuple(_clone(x) for x in kp), "prev_pose": _clone(prev_pose),
                       "pose_in": _clone(tr._pose)}
            pose, ok = inner(intensity, depth)
            if cap is not None:
                cap["pose"] = _clone(pose)
                self.caps[self.current] = cap
            return pose, ok

        tr.track = track

    def before_frame(self, j: int) -> None:
        self.current = j if self.sampler.take() else None

    def after_window(self) -> None:
        del self.tracker.track  # the class's method again
        ctx = self.ctx
        self.samples = []
        for j, cap in sorted(self.caps.items()):
            smp = {k: (tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu())
                   for k, v in cap.items()}
            smp["rgb"] = ctx.traffic.frame(ctx.traffic.warmup + j)[0]
            self.samples.append(smp)

    def readings(self, control: bool = False):
        return mono.sparse_readings(self.ctx.config, mono_base.reference_net(self.ctx),
                                    self.samples, self.ctx.device, control=control)
