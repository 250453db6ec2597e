"""``intermap_pose_gap``, ``merge_map_gap``, ``merge_pose_gap``: the
window's inter-map merges, the first ``merges`` of them, each held
against the plain reference run again from the program's inputs
(`reference.merge`).

The probes wrap the engine's `_try_intermap` and `merge_into` and the
module functions `loops.verify_recovery` (which `loops.resolve_intermap`
calls) and `loops.merge_maps`; they take device-side clones and move them
to the host after the window:

- at each inter-map query of the window, the joiner's frame as uploaded
  and its pose in its own map, and the fern candidate's pose that the
  verification starts from;
- at the merge that query leads to, the program's ``T_ab``, the session
  tick, each moving camera's pose, keyframe pose and pose history, and
  the fern databases' poses and counts;
- right after `loops.merge_maps`, whose read of the two counts waits for
  the card anyway, the rows of map A and of map B below their counts
  (`merge_maps` writes B only past its count; the compaction after it
  rewrites B);
- just after `merge_into`, the merged map's rows below B's count plus A's
  (a bound known on the host: no wait), the moved cameras' poses and pose
  histories, and B's fern poses.

Readings, each the largest over the merges copied: ``intermap_pose_gap``,
the largest 4x4 entry gap of the program's ``T_ab`` from the reference's,
whose verification renders B's rows at the candidate's pose and tracks the
joiner's frame onto them; ``merge_map_gap``, the 99.9th percentile over
every live row of the merged map of the row's largest entry gap from the
reference's merge of A into B with its own ``T_ab`` (infinite where the
counts differ); ``merge_pose_gap``, the largest entry gap of the moved
poses, pose histories and fern poses from the reference's.  A window
with fewer merges than ``merges``, or one the reference's verification
refuses, reads infinite, so the run is not correct.  Each merge's
direction, tick and rows moved are logged.  Parameter: ``merges``."""

from __future__ import annotations

import math

import numpy as np
import torch

from checks.base import Check as _Base
from reference import checks as ref
from reference import merge as rmerge
from reference import surfel_map as rsm

KEYS = ("intermap_pose_gap", "merge_map_gap", "merge_pose_gap")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


class Check(_Base):
    def before_window(self) -> None:
        from densemonoslam_tpu_torch import loops

        ctx = self.ctx
        eng = ctx.engine
        self.loops = loops
        self.want = int(self.params["merges"])
        self.caps = []
        self.query = None  # the inter-map query under way, while one is copied
        self.pending = None  # the merge being copied
        self._try, self._merge = eng._try_intermap, eng.merge_into
        self._verify, self._merge_maps = loops.verify_recovery, loops.merge_maps
        eng._try_intermap, eng.merge_into = self._try_probe, self._merge_probe
        loops.verify_recovery, loops.merge_maps = self._verify_probe, self._merge_maps_probe

    def _copying(self) -> bool:
        return self.ctx.in_window and len(self.caps) < self.want

    def _try_probe(self, fe, rgb, depth_raw):
        if self._copying():
            self.query = {"camera": fe.name, "rgb": rgb.clone(), "depth": depth_raw.clone(),
                          "pose": fe.state.pose.clone(), "candidate": None}
        try:
            return self._try(fe, rgb, depth_raw)
        finally:
            self.query = None

    def _verify_probe(self, frame_pyr, recovery, *a, **k):
        if self.query is not None:
            self.query["candidate"] = recovery.clone()
        return self._verify(frame_pyr, recovery, *a, **k)

    def _merge_maps_probe(self, data_b, count_b, data_a, count_a, T_ab):
        out = self._merge_maps(data_b, count_b, data_a, count_a, T_ab)
        cap = self.pending
        if cap is not None:
            # merge_maps has read both counts on the host: these reads wait
            # only for its copy of A's rows into B
            cb, ca = int(count_b), int(count_a)
            cap.update(rows_b=data_b[:cb].clone(), rows_a=data_a[:ca].clone(),
                       bound=min(cb + ca, data_b.shape[0] - 1))
        return out

    def _members(self, eng, names) -> dict:
        out = {}
        for name in names:
            f = eng.frontends[name]
            n = len(f.ts_log)
            out[name] = {"pose": f.state.pose.clone(), "kf_pose": f.state.kf_pose.clone(),
                         "hist": f.pose_hist[:n].clone() if n else None}
        return out

    def _merge_probe(self, src_map, dst_map, T_ab):
        ctx = self.ctx
        if self.query is None or self.query["candidate"] is None or not self._copying():
            return self._merge(src_map, dst_map, T_ab)
        eng = ctx.engine
        src, dst = eng.maps[src_map], eng.maps[dst_map]
        names = list(src.contexts)
        dst_fe = eng.frontends[dst.contexts[0]]

        def db_of(f):
            return None if f.fern_state is None else f.fern_state.db

        cap = {"query": self.query, "T": np.array(T_ab, np.float32), "src": src_map,
               "dst": dst_map, "tick": float(eng.global_tick),
               "capacity": int(dst.map_data.shape[0] - 1),
               "before": self._members(eng, names),
               "ferns_a": [(db_of(eng.frontends[n]).poses.clone(),
                            db_of(eng.frontends[n]).count.clone())
                           for n in names if db_of(eng.frontends[n]) is not None],
               "fern_b_count": None if db_of(dst_fe) is None else db_of(dst_fe).count.clone()}
        self.pending = cap
        try:
            out = self._merge(src_map, dst_map, T_ab)
        finally:
            self.pending = None
        be = eng.maps[dst_map]
        cap.update(merged=be.map_data[: cap.pop("bound")].clone(),
                   merged_count=be.map_count.clone(),
                   after=self._members(eng, names),
                   fern_b=None if db_of(dst_fe) is None else db_of(dst_fe).poses.clone(),
                   first_moved=ctx.frontend.name if ctx.frontend.name in names else None)
        self.caps.append(cap)
        return out

    def after_window(self) -> None:
        ctx = self.ctx
        ctx.engine._try_intermap, ctx.engine.merge_into = self._try, self._merge
        self.loops.verify_recovery, self.loops.merge_maps = self._verify, self._merge_maps
        caps = []
        for cap in self.caps:
            m_n = int(cap.pop("merged_count"))
            cap["merged"] = cap["merged"][:m_n]
            cap["ferns_a"] = [(p[: int(c)].cpu()) for p, c in cap["ferns_a"]]
            if cap["fern_b_count"] is not None:
                cap["fern_b_count"] = int(cap["fern_b_count"])
            cap = _host(cap)
            moved = int((cap["rows_a"][:, rsm.CONF] > 0).sum())
            ctx.log(f"merge: map {cap['src']} into {cap['dst']} at session tick "
                    f"{cap['tick']:.0f}, cameras moved {', '.join(cap['before'])}; "
                    f"rows {cap['rows_b'].shape[0]} + {moved} live moved -> {m_n}")
            if cap["first_moved"]:
                ctx.log(f"merge: {cap['first_moved']}'s map moved: its step was captured again, "
                        "and a probe wrapped around its old step no longer sees it")
            caps.append(cap)
        self.caps = caps
        if len(caps) < self.want:
            ctx.log(f"merge: {len(caps)} merges in the window, {self.want} asked for")

    def readings(self, control: bool = False):
        ctx = self.ctx
        if len(self.caps) < self.want:
            return dict.fromkeys(KEYS, math.inf)
        gaps = dict.fromkeys(KEYS, 0.0)
        for cap in self.caps:
            for k, v in self._gaps(cap, control).items():
                gaps[k] = max(gaps[k], v)
        ctx.log(f"merge{' control' if control else ''}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in gaps.items()))
        return gaps

    def _gaps(self, cap: dict, control: bool) -> dict:
        ctx, dev = self.ctx, self.ctx.device
        cfg = ref.engine_config(ctx.config)
        intr = ref.intrinsics(ctx.config)
        H, W = int(ctx.config["camera"]["height"]), int(ctx.config["camera"]["width"])
        q = cap["query"]
        N = cap["capacity"]
        max_active = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

        def run(tf32: bool):
            with ref.tf32(tf32):
                pose_b, info = rmerge.verify(
                    q["rgb"].to(dev), q["depth"].to(dev), q["candidate"].to(dev),
                    cap["rows_b"].to(dev), N, cfg, intr, W, H)
                if pose_b is None:
                    ctx.log(f"merge: the reference{' in TF32' if tf32 else ''} refuses the "
                            f"verification the program accepted: {info}")
                    return None
                T = rmerge.relative(pose_b, q["pose"])
                merged, _ = rmerge.merge_maps(cap["rows_b"].to(dev), cap["rows_a"].to(dev),
                                              N, T, cap["tick"], cfg.time_delta, max_active)
                moved = {name: {k: None if v is None else rmerge.move_poses(T, v.to(dev)).cpu()
                                for k, v in m.items()} for name, m in cap["before"].items()}
                ferns = [rmerge.move_poses(T, p.to(dev)).cpu() for p in cap["ferns_a"]]
                return {"T": T, "merged": merged.cpu(), "members": moved, "ferns": ferns}

        want = run(False)
        if want is None:
            return dict.fromkeys(KEYS, math.inf)
        if control:
            got = run(True)
            if got is None:
                return dict.fromkeys(KEYS, math.inf)
        else:
            cb = cap["fern_b_count"]
            ferns = []
            for p in cap["ferns_a"]:
                n = min(p.shape[0], cap["fern_b"].shape[0] - cb) if cb is not None else 0
                ferns.append(cap["fern_b"][cb: cb + n])
                cb = None if cb is None else cb + n
            got = {"T": torch.from_numpy(cap["T"]), "merged": cap["merged"],
                   "members": cap["after"], "ferns": ferns}
        t_gap = ref.pose_gap(got["T"].numpy(), want["T"].numpy())
        a, b = got["merged"], want["merged"]
        if a.shape != b.shape:
            ctx.log(f"merge: the merged map holds {a.shape[0]} rows, the reference's {b.shape[0]}")
            m_gap = math.inf
        elif a.shape[0] == 0:
            m_gap = 0.0
        else:
            row = (a.double() - b.double()).abs().amax(dim=1).numpy()
            m_gap = float(np.quantile(row, ref.GAP_QUANTILE))
        p_gaps = [0.0]
        for name, m in want["members"].items():
            for k, v in m.items():
                g = got["members"][name][k]
                if v is None or g is None:
                    p_gaps.append(0.0 if v is None and g is None else math.inf)
                elif g.shape != v.shape:
                    p_gaps.append(math.inf)
                else:
                    p_gaps.append(ref.pose_gap(g.numpy(), v.numpy()))
        for g, v in zip(got["ferns"], want["ferns"]):
            n = min(g.shape[0], v.shape[0])
            p_gaps.append(ref.pose_gap(g[:n].numpy(), v[:n].numpy()) if n else 0.0)
        return {"intermap_pose_gap": t_gap, "merge_map_gap": m_gap,
                "merge_pose_gap": max(p_gaps)}
