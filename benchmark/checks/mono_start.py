"""``mono_start_pose_gap``, ``mono_start_map_gap``: the monocular run's
first frames from an empty map.  After set-up frame ``frames - 1`` the
program's poses of those frames and its map's live rows are copied to the
host; the reference runs the depth CNN, the tracker's frame chain and the
step over the same frames by itself (`reference.mono.start_readings`).
Parameters: ``frames`` (fewer than the tracker's first bundle adjustment
writes back, which the chain leaves out)."""

from __future__ import annotations

from checks import mono_base
from checks.start import Check as _Start
from reference import mono


class Check(_Start):
    def readings(self, control: bool = False):
        ctx = self.ctx
        n = int(self.params["frames"])
        rgbs = [ctx.traffic.frame(k)[0] for k in range(n)]
        return mono.start_readings(ctx.config, mono_base.reference_net(ctx), rgbs,
                                   ctx.traffic.gt_pose(0), None if control else self.poses,
                                   None if control else self.rows, ctx.device, control=control)
