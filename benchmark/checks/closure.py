"""``closure_gap``: accepted local loop closures of the window, drawn from
the seed by time (`base.Sampler`, over the window's first four fifths):
for each time drawn, the first loop check at or after it that the
program accepts. The probe wraps `loops.try_local_loop`, which
`Engine.process_frame` calls through the module; while a drawn closure
is pending, each check keeps, on the card and without a wait, ``rows``
map rows drawn from the seed and the camera pose as the check is given
them, and the deformation graph's inputs (nodes, constraints, frozen
mask, carried relative constraints, through
`mapping.deformation.optimise_graphed`); once the program accepts, the
same rows after the deformation and the pose. The reference solves the
graph again from the program's inputs and deforms the rows and the pose
through it (`reference.checks.closure_readings`). Parameters:
``closures``, ``rows``."""

from __future__ import annotations

import torch

from checks.base import Check as _Base, Sampler
from reference import checks as ref


def _clone(xs):
    return tuple(x.detach().clone() for x in xs)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x if x.device.type == "cpu" else x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    return x


class Check(_Base):
    def before_window(self) -> None:
        from densemonoslam_tpu_torch import loops
        from densemonoslam_tpu_torch.mapping import deformation as dg

        ctx = self.ctx
        self.loops, self.dg = loops, dg
        n = int(self.params["closures"])
        # a time drawn leaves a fifth of the window for the next accepted
        # closure to come: every ~1.2 s in the revisit lap
        self.sampler = Sampler(ctx, n, salt=3, last_share=0.8)
        self.rows = int(self.params["rows"])
        self.gen = torch.Generator(device=ctx.device)
        self.gen.manual_seed(ctx.seed % (1 << 63))
        self.pending = 0  # times drawn whose closure has not come yet
        self.captures = []
        self._orig = loops.try_local_loop
        loops.try_local_loop = self._check

    def before_frame(self, j: int) -> None:
        if self.sampler.take():
            self.pending += 1

    def _check(self, state, camera, cfg, rel_bank=None):
        ctx = self.ctx
        if not (self.pending and ctx.in_window):
            return self._orig(state, camera, cfg, rel_bank=rel_bank)
        data, count = state.map_data, state.map_count
        u = torch.rand(self.rows, generator=self.gen, device=data.device, dtype=torch.float64)
        idx = torch.minimum((u * count.to(torch.float64)).long(), torch.clamp(count - 1, min=0))
        cap = {"idx": idx, "rows_before": data[idx].clone(), "pose_before": state.pose.clone(),
               "tick": state.tick.clone()}
        solve = self.dg.optimise_graphed

        def optimise(graph, cons, frozen=None, *a, rel=None, **k):
            cap["solve"] = {"graph": _clone(graph), "cons": _clone(cons),
                            "frozen": (frozen if frozen is not None
                                       else torch.zeros_like(graph.valid)).clone(),
                            "rel": None if rel is None else _clone(rel)}
            return solve(graph, cons, frozen, *a, rel=rel, **k)

        probing, ctx.probing = ctx.probing, True
        self.dg.optimise_graphed = optimise
        try:
            out = self._orig(state, camera, cfg, rel_bank=rel_bank)
        finally:
            ctx.probing = probing
            self.dg.optimise_graphed = solve
        new_state, info = out[0], out[1]
        if info.closed:
            cap.update(rows_after=new_state.map_data[idx].clone(),
                       pose_after=new_state.pose.clone())
            self.captures.append(cap)
            self.pending -= 1
        return out

    def after_window(self) -> None:
        self.loops.try_local_loop = self._orig
        self.captures = [_to_host(c) for c in self.captures]

    def readings(self, control: bool = False):
        return ref.closure_readings(self.ctx.config, self.captures, self.ctx.device,
                                    control=control)
