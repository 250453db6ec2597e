"""``start_pose_gap``, ``start_map_gap``: the run's first frames from an
empty map.  After set-up frame ``frames - 1`` the program's poses of those
frames and its map's live rows are copied to the host; the reference runs
the same frames from an empty map by itself (`reference.checks.start_readings`).
Parameters: ``frames`` (fewer than the loop check could close on)."""

from __future__ import annotations

import torch

from checks.base import Check as _Base
from reference import checks as ref

POSE = slice(13, 29)  # the stats row's tracked pose, row-major


class Check(_Base):
    def after_setup_frame(self, j: int) -> None:
        n = int(self.params["frames"])
        if j + 1 != n:
            return
        ctx = self.ctx
        ctx.sync()
        be = ctx.engine.backend_of(ctx.frontend.name)
        count = int(be.map_count)
        self.poses = torch.stack(ctx.frontend.stats_log[:n])[:, POSE].reshape(-1, 4, 4).cpu().numpy()
        self.rows = be.map_data[:count].cpu().clone()

    def readings(self, control: bool = False):
        ctx = self.ctx
        n = int(self.params["frames"])
        frames = [ctx.traffic.frame(k) for k in range(n)]
        return ref.start_readings(ctx.config, frames, ctx.traffic.gt_pose(0),
                                  None if control else self.poses,
                                  None if control else self.rows, ctx.device, control=control)
