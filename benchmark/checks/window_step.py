"""``window_step_pose_gap``, ``window_step_map_gap``: whole steps of
window frames drawn from the seed by time (`base.Sampler`), the map at its
full size.  A step reads and writes only the map's active tail block and
the rows it appends (`reference.checks.step_block`); for a drawn frame
the probe, which wraps the camera's `step_fn` (the graph replay), gathers
that block on the card before the step and again after it, copies each
into pinned host buffers behind the frame's work, without a wait, with
every other field of the state the step is given and returns, the
step's pose input and flag, and the pose its stats row reports (the one
the engine logs).  The reference runs its own step from the
copied state on the same frame (RGB-D: the frame's depth; monocular: its
own CNN's depth of the frame) and compares the pose, the block after the
step and the stored prediction (`reference.checks.window_step_readings`).
The step's pose is compared where the step tracks it: with
``orb_tracking`` the step is handed the sparse tracker's pose, which
``sparse_pose_gap`` compares.  Parameters: ``frames``; ``map`` (default
true; false leaves the map's reading out, where it does not separate sound
runs from the control: `PERF.md` §2); ``pose`` (default ``"largest"``:
``window_step_pose_gap``, the largest frame's gap; ``"median"``:
``window_step_pose_gap_median``, the median of the frames whose step tracked
in the reference, where a single frame's pose is ill-conditioned and the
largest does not separate sound runs from the control: `PERF.md` §2).  Each
frame's pose gap is logged."""

from __future__ import annotations

import torch

from checks import mono_base
from checks.base import Check as _Base, Sampler
from reference import checks as ref


def _host_like(x: torch.Tensor, pin: bool) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)


class Check(_Base):
    def before_window(self) -> None:
        ctx = self.ctx
        n = int(self.params["frames"])
        self.sampler = Sampler(ctx, n, salt=4)
        cfg = ref.engine_config(ctx.config)
        st = ctx.frontend.state
        H, W = st.pred_depth.shape
        self.win, self.rows = ref.step_block(cfg, st.map_data.shape[0] - 1, H * W)
        pin = ctx.on_card
        small = [f for f in ref.STEP_FIELDS if f != "map_data"]
        self.block = torch.empty((self.rows, st.map_data.shape[1]), dtype=st.map_data.dtype,
                                 device=st.map_data.device)
        self.idx = torch.empty((self.rows,), dtype=torch.int64, device=st.map_data.device)
        self.free = [{side: dict({f: _host_like(getattr(st, f), pin) for f in small},
                                 block=_host_like(self.block, pin))
                      for side in ("pre", "post")} for _ in range(n)]
        self.caps = {}
        self.current = None
        fe = ctx.frontend
        inner = fe.step_fn

        def keep(state, bufs):
            for f, buf in bufs.items():
                if f != "block":
                    buf.copy_(getattr(state, f), non_blocking=True)
            torch.index_select(state.map_data, 0, self.idx, out=self.block)
            bufs["block"].copy_(self.block, non_blocking=True)

        def step(state, rgb, depth_raw, in_pose, use_in, weight, cluster=0.0):
            if self.current is None:
                return inner(state, rgb, depth_raw, in_pose, use_in, weight, cluster)
            bufs = self.free.pop()
            N = state.map_data.shape[0] - 1
            start = torch.clamp(state.map_count - self.win, 0, max(N - self.win, 0))
            torch.clamp(start + torch.arange(self.rows, device=start.device), max=N, out=self.idx)
            start_host = torch.empty((), dtype=torch.int64, pin_memory=ctx.on_card)
            start_host.copy_(start, non_blocking=True)
            keep(state, bufs["pre"])
            use = use_in.detach().clone() if isinstance(use_in, torch.Tensor) else bool(use_in)
            cap = {"pre": bufs["pre"], "post": bufs["post"], "start": start_host,
                   "pose_in": in_pose.detach().clone(), "use_in": use,
                   "weight": float(weight), "cluster": float(cluster)}
            new_state, stats = inner(state, rgb, depth_raw, in_pose, use_in, weight, cluster)
            keep(new_state, bufs["post"])
            cap["stats_pose"] = stats[ref.rstep.STAT_POSE0:].detach().clone()
            self.caps[self.current] = cap
            return new_state, stats

        fe.step_fn = step

    def before_frame(self, j: int) -> None:
        self.current = j if (self.free and self.sampler.take()) else None
        # the copies hold this frame's later reads: its timings are left out
        self.ctx.probing = self.current is not None

    def after_window(self) -> None:
        ctx = self.ctx
        self.samples = []
        for j, cap in sorted(self.caps.items()):
            k = ctx.traffic.warmup + j
            rgb, depth = ctx.traffic.frame(k)
            smp = dict(cap, rgb=rgb, depth=depth, frame=j,
                       fused=float(ctx.frontend.stats_log[k][ref.rstep.STAT_FUSED]),
                       capacity=int(ctx.frontend.state.map_data.shape[0] - 1))
            for key in ("pose_in", "use_in", "stats_pose"):
                if isinstance(smp[key], torch.Tensor):
                    smp[key] = smp[key].cpu()
            self.samples.append(smp)
        ctx.log(f"window_step: {len(self.samples)} frames drawn, "
                f"{sum(s['fused'] > 0 for s in self.samples)} of them fused")
        self.free = []
        self.block = self.idx = None

    def readings(self, control: bool = False):
        ctx = self.ctx
        net = mono_base.reference_net(ctx) if ctx.config.get("depth_net") else None
        pose = self.params.get("pose", "largest")
        gaps = []
        out = ref.window_step_readings(ctx.config, self.samples, net, ctx.device, control=control,
                                       pose=pose, gaps=gaps)
        ctx.log(f"window_step{' control' if control else ''} pose gaps (frame, gap, tracked): "
                + ", ".join(f"({j}, {g:.4g}, {int(t)})" for j, g, t in gaps))
        if ctx.config["engine"].get("orb_tracking"):
            del out["window_step_pose_gap" if pose == "largest" else "window_step_pose_gap_median"]
        if not self.params.get("map", True):
            del out["window_step_map_gap"]
        return out
