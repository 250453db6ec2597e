"""``rejoin_pose_gap``, ``rejoin_map_gap``, ``joined_step_pose_gap_median``:
the steps of a camera (``camera``) after a merge moved its map into
another's, held as `window_step` holds the first camera's: the reference
runs the whole step again from the state the step was given and compares
the pose, the map's block after the step and the stored prediction
(`reference.checks.run_step`, `step_block`).

- The rejoin steps: the camera's first ``rejoin`` steps after its map
  moved, every one.  On the card the first is the one `Engine._recompile`
  captured again over the merged map; it starts from the moved pose with
  the model marked stale, so it renders the merged map's active block and
  neither tracks nor fuses; the next ones track against the merged map,
  and fuse into it where the view is novel.  ``rejoin_pose_gap`` and
  ``rejoin_map_gap`` are the largest over them.
- The joined steps: ``frames`` of the camera's window steps after them,
  drawn from the seed by time (`base.Sampler`; the times before the
  rejoin steps end draw the first step after them, once).
  ``joined_step_pose_gap_median`` is the median pose gap of those whose
  step tracked in the reference (of all where none did): the loop layer's
  single steps can be ill-conditioned (`PERF.md` §2).  Their map gaps are
  logged, not compared: most drawn steps do not fuse, so the TF32
  control's median reads 0 on some seeds.

The block after the step is read from the map's backend once the engine
has handed the step's map to it (`Engine._set_map`), so rows the step
wrote and the engine lost read as a gap.  The probe wraps the camera's
`step_fn` at each of its frames in the window whose `step_fn` is not
already wrapped, so a step captured again after a merge is followed.
Copies are device-side and go to pinned host buffers without a wait;
their frames count as probed (`ctx.probing`).  A window in which the
camera's map never moves, or which ends before its rejoin steps, reads
infinite, so the run is not correct.  Each sample's pose and map gaps
are logged with whether the program's step fused.  Parameters:
``camera``, ``frames``, ``rejoin``."""

from __future__ import annotations

import math
import statistics

import torch

from checks.base import Check as _Base, Sampler
from checks.window_step import _host_like
from reference import checks as ref

KEYS = ("rejoin_pose_gap", "rejoin_map_gap", "joined_step_pose_gap_median")


class Check(_Base):
    def before_window(self) -> None:
        ctx = self.ctx
        self.name = self.params["camera"]
        self.fe = ctx.frontends[self.name]
        self.rejoin = int(self.params["rejoin"])
        n = int(self.params["frames"])
        self.sampler = Sampler(ctx, n, salt=17)
        cfg = ref.engine_config(ctx.config)
        st = self.fe.state
        H, W = st.pred_depth.shape
        self.win, self.rows = ref.step_block(cfg, st.map_data.shape[0] - 1, H * W)
        pin = ctx.on_card
        small = [f for f in ref.STEP_FIELDS if f != "map_data"]
        self.block = torch.empty((self.rows, st.map_data.shape[1]), dtype=st.map_data.dtype,
                                 device=st.map_data.device)
        self.idx = torch.empty((self.rows,), dtype=torch.int64, device=st.map_data.device)
        self.free = {kind: [{side: dict({f: _host_like(getattr(st, f), pin) for f in small},
                                        block=_host_like(self.block, pin))
                             for side in ("pre", "post")} for _ in range(count)]
                     for kind, count in (("rejoin", self.rejoin), ("joined", n))}
        self.map0 = self.fe.map_name
        self.rejoin_left = None  # rejoin steps still to copy, once the map moved
        self.caps = []
        self.current = None  # (kind, run frame) of the frame under way, when copied
        self.landing = None  # the copy whose block is read after `_set_map`
        self.wrapped = None
        eng = ctx.engine
        self._frame, self._set_map = eng.process_frame, eng._set_map
        eng.process_frame, eng._set_map = self._frame_probe, self._set_map_probe

    def _keep(self, state, bufs, data=None, count=None) -> None:
        for f, buf in bufs.items():
            if f != "block":
                buf.copy_(getattr(state, f), non_blocking=True)
        if count is not None:
            bufs["map_count"].copy_(count, non_blocking=True)
        src = state.map_data if data is None else data
        torch.index_select(src, 0, self.idx, out=self.block)
        bufs["block"].copy_(self.block, non_blocking=True)

    def _wrap(self) -> None:
        inner = self.fe.step_fn
        ctx = self.ctx

        def step(state, rgb, depth_raw, in_pose, use_in, weight, cluster=0.0):
            if self.current is None:
                return inner(state, rgb, depth_raw, in_pose, use_in, weight, cluster)
            kind, k = self.current
            bufs = self.free[kind].pop()
            N = state.map_data.shape[0] - 1
            start = torch.clamp(state.map_count - self.win, 0, max(N - self.win, 0))
            torch.clamp(start + torch.arange(self.rows, device=start.device), max=N, out=self.idx)
            start_host = torch.empty((), dtype=torch.int64, pin_memory=ctx.on_card)
            start_host.copy_(start, non_blocking=True)
            self._keep(state, bufs["pre"])
            use = use_in.detach().clone() if isinstance(use_in, torch.Tensor) else bool(use_in)
            cap = {"kind": kind, "k": k, "pre": bufs["pre"], "post": bufs["post"],
                   "start": start_host, "pose_in": in_pose.detach().clone(), "use_in": use,
                   "weight": float(weight), "cluster": float(cluster)}
            new_state, stats = inner(state, rgb, depth_raw, in_pose, use_in, weight, cluster)
            cap["new_state"] = new_state
            cap["stats_pose"] = stats[ref.rstep.STAT_POSE0:].detach().clone()
            self.landing = cap
            return new_state, stats

        self.fe.step_fn = self.wrapped = step

    def _set_map_probe(self, be, data, count) -> None:
        self._set_map(be, data, count)
        cap, self.landing = self.landing, None
        if cap is not None:
            # the state the step returned, with the block and count the map holds now
            self._keep(cap.pop("new_state"), cap["post"], data=be.map_data, count=be.map_count)
            self.caps.append(cap)

    def _frame_probe(self, name, *a, **k):
        ctx = self.ctx
        if name != self.name or not ctx.in_window:
            return self._frame(name, *a, **k)
        if self.rejoin_left is None and self.fe.map_name != self.map0:
            self.rejoin_left = self.rejoin
        kind = None
        if self.rejoin_left and not ctx.in_span:
            kind, self.rejoin_left = "rejoin", self.rejoin_left - 1
        elif self.rejoin_left == 0 and self.free["joined"] and self.sampler.take():
            kind = "joined"
        if kind is None:
            return self._frame(name, *a, **k)
        if self.fe.step_fn is not self.wrapped:
            self._wrap()
        old = ctx.probing
        self.current, ctx.probing = (kind, int(a[2])), True
        try:
            return self._frame(name, *a, **k)
        finally:
            self.current, ctx.probing, self.landing = None, old, None

    def after_window(self) -> None:
        ctx = self.ctx
        eng = ctx.engine
        eng.process_frame, eng._set_map = self._frame, self._set_map
        traffic = ctx.traffics[self.name]
        self.samples = []
        for cap in self.caps:
            k = cap["k"]
            rgb, depth = traffic.frame(k)
            smp = dict(cap, rgb=rgb, depth=depth, frame=k,
                       fused=float(self.fe.stats_log[k][ref.rstep.STAT_FUSED]),
                       capacity=int(self.fe.state.map_data.shape[0] - 1))
            for key in ("pose_in", "use_in", "stats_pose"):
                if isinstance(smp[key], torch.Tensor):
                    smp[key] = smp[key].cpu()
            self.samples.append(smp)
        kinds = [s["kind"] for s in self.samples]
        ctx.log(f"joined_step: {self.name}'s map "
                f"{'moved' if self.rejoin_left is not None else 'never moved'} in the window; "
                f"{kinds.count('rejoin')} rejoin and {kinds.count('joined')} joined steps copied, "
                f"{sum(s['fused'] > 0 for s in self.samples)} of them fused")
        self.free = {}
        self.block = self.idx = None

    def readings(self, control: bool = False):
        ctx = self.ctx
        rows = []  # (kind, frame, pose gap, map gap, tracked, fused)
        for smp in self.samples:
            rows.append((smp["kind"], smp["frame"]) + self._gaps(smp, control)
                        + (smp["fused"] > 0,))
        ctx.log(f"joined_step{' control' if control else ''} (kind, {self.name}'s frame, pose "
                "gap, map gap, tracked, fused): " + ", ".join(
                    f"({a}, {b}, {c:.4g}, {d:.4g}, {int(e)}, {int(f)})"
                    for a, b, c, d, e, f in rows))
        rejoin = [r for r in rows if r[0] == "rejoin"]
        joined = [r for r in rows if r[0] == "joined"]
        if len(rejoin) < self.rejoin or not joined:
            return dict.fromkeys(KEYS, math.inf)
        tracked = [r for r in joined if r[4]] or joined
        return {"rejoin_pose_gap": max(r[2] for r in rejoin),
                "rejoin_map_gap": max(r[3] for r in rejoin),
                "joined_step_pose_gap_median": statistics.median(r[2] for r in tracked)}

    def _gaps(self, smp: dict, control: bool) -> tuple:
        """(pose gap, map gap, tracked in the reference) of one copied step,
        as `reference.checks.window_step_readings` takes them."""
        config, dev = self.ctx.config, self.ctx.device
        start = int(smp["start"])
        keys = ("map_count", "pose", "pred_depth")
        with ref.tf32(False):
            r, r_block, r_row = ref.run_step(config, smp, None, dev)
            want = dict({f: getattr(r, f) for f in keys}, block=r_block,
                        stats_pose=r_row[ref.rstep.STAT_POSE0:])
            tracked = bool(r_row[ref.rstep.STAT_TRACK_OK] > 0)
            del r
        got = dict(smp["post"], stats_pose=smp["stats_pose"])
        if control:
            with ref.tf32(True):
                c, c_block, c_row = ref.run_step(config, smp, None, dev)
                got = dict({f: getattr(c, f) for f in keys}, block=c_block,
                           stats_pose=c_row[ref.rstep.STAT_POSE0:])
                del c
        pose = want["pose"].cpu().numpy()
        pose_gap = max(ref.pose_gap(got["pose"].cpu().numpy(), pose),
                       ref.pose_gap(got["stats_pose"].cpu().numpy(),
                                    want["stats_pose"].cpu().numpy()))
        with ref.tf32(False):
            d_want = ref.render_depth(ref._block_rows(want["block"], start, want["map_count"], dev),
                                      pose, config)
            d_got = ref.render_depth(ref._block_rows(got["block"], start, got["map_count"], dev),
                                     pose, config)
            map_gap = max(ref.map_gap(d_got, d_want),
                          ref.map_gap(got["pred_depth"].to(dev), want["pred_depth"].to(dev)))
        return pose_gap, map_gap, tracked
