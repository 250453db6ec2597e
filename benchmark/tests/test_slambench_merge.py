"""The merge and joined-step checks and the inter-map metrics on the CPU
at 160x120: a two-camera cell whose second camera joins late and is
merged into the first camera's map reads `correct`, also where the moved
camera's step is built again after the merge, as on the card; a merge
whose moved rows are shifted 1 mm, which drops 3% of them, which shifts
the moved camera's pose history 1 mm, or a window with no merge, does
not; nor do the moved camera's steps after the merge where the first one
runs on its old map, where their poses are shifted 1 mm, or where every
33rd row they leave in the map is moved 2 cm; `intermap_ms` and `merge_ms`
read numbers on a traced run, and nothing on a program without the
inter-map counters or the merge's spans."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench_tiny import make_copy, metric_entry, run

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

torch.set_num_threads(2)

CELL = "tiny_collab.two_cameras"
KEYS = ("intermap_pose_gap", "merge_map_gap", "merge_pose_gap")
JOINED = ("rejoin_pose_gap", "rejoin_map_gap", "joined_step_pose_gap_median")


def _collab(tmp_path: Path) -> Path:
    """The copy with the tiny RGB-D configuration at two cameras and a cell
    with the real cell's merge check and limits: camera 1 starts at lap
    frame 23 and joins four ticks before the window, so that its first
    loop check (its 8th frame, three ticks into the window) finds it in
    camera 0's map, well before the traced span."""
    bench = make_copy(tmp_path)
    config = json.loads((bench / "configs" / "tiny_rgbd.json").read_text())
    config.update(name="tiny_collab", cameras=2)
    real = json.loads((BENCH / "workloads" / "rgbd_vga_collab.two_cameras.json").read_text())
    cell = json.loads((bench / "workloads" / "tiny_rgbd.revisit_lap.json").read_text())
    cell.update(name=CELL, config="tiny_collab", trace={"start_s": 3.0, "span_s": 0.5},
                checks={"start": real["checks"]["start"],
                        "window_step": dict(real["checks"]["window_step"], frames=2),
                        "merge": real["checks"]["merge"],
                        "joined_step": dict(real["checks"]["joined_step"], frames=3,
                                            rejoin=2)},
                limits={k: v for k, v in real["limits"].items() if k != "closure_gap"})
    warmup = cell["traffic"]["warmup_frames"]
    cell["traffic"]["per_camera"] = [{"offset": 0, "join": 0},
                                     {"offset": 23, "join": warmup - 4}]
    (bench / "configs" / "tiny_collab.json").write_text(json.dumps(config))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny_collab", "traffic": "two_cameras",
                              "chips": 1, "why": "the tests' small copy"})
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] not in ("intermap_ms", "merge_ms")]
    spec["per_layer"] += [metric_entry(bench, name, "lower", [CELL])
                          for name in ("intermap_ms", "merge_ms")]
    spec_path.write_text(json.dumps(spec))
    return bench


def _fault(monkeypatch, fault: str) -> None:
    from densemonoslam_tpu_torch import loops
    from densemonoslam_tpu_torch.engine import Engine
    from densemonoslam_tpu_torch.mapping import surfel_map as sm

    real_merge, real_into = loops.merge_maps, Engine.merge_into
    if fault == "rows_shifted":
        def merge_maps(data_b, count_b, data_a, count_a, T):
            shifted = data_a.clone()
            shifted[:, 0] += 1e-3
            return real_merge(data_b, count_b, shifted, count_a, T)

        monkeypatch.setattr(loops, "merge_maps", merge_maps)
    elif fault == "rows_dropped":
        def merge_maps(data_b, count_b, data_a, count_a, T):
            thinned = data_a.clone()
            live = torch.nonzero(thinned[:, sm.CONF] > 0).flatten()
            gone = live[torch.randperm(live.numel(), generator=torch.Generator().manual_seed(0))]
            thinned[gone[: max(1, int(0.03 * live.numel()))], sm.CONF] = 0.0
            return real_merge(data_b, count_b, thinned, count_a, T)

        monkeypatch.setattr(loops, "merge_maps", merge_maps)
    elif fault == "history_shifted":
        def merge_into(self, src_map, dst_map, T_ab):
            moved = list(self.maps[src_map].contexts)
            real_into(self, src_map, dst_map, T_ab)
            for name in moved:
                fe = self.frontends[name]
                fe.pose_hist[: len(fe.ts_log), 0, 3] += 1e-3

        monkeypatch.setattr(Engine, "merge_into", merge_into)
    elif fault == "no_merge":
        monkeypatch.setattr(loops, "resolve_intermap",
                            lambda *a, **k: (None, False, {"dissim": 1.0}))


@pytest.mark.parametrize("fault", [None, "rows_shifted", "rows_dropped", "history_shifted",
                                   "no_merge"])
def test_the_merge_check_holds_the_merge(tmp_path, capsys, monkeypatch, fault):
    if fault:
        _fault(monkeypatch, fault)
    bench = _collab(tmp_path)
    rc, out = run(bench, seed=4000000051, seconds=3.0, capsys=capsys, cell=CELL)
    assert rc == 0 and out is not None
    checks = out["checks"]
    assert out["correct"] is (fault is None), checks
    over = {k for k in KEYS
            if checks[k]["value"] is None or checks[k]["value"] > checks[k]["limit"]}
    want = {None: set(), "rows_shifted": {"merge_map_gap"}, "rows_dropped": {"merge_map_gap"},
            "history_shifted": {"merge_pose_gap"}, "no_merge": set(KEYS)}[fault]
    assert over == want, checks


def _moved_step_fault(monkeypatch, fault: str) -> None:
    """After a merge, each moved camera's step built again (as the card's
    `Engine.merge_into` does), and with `fault` broken after it: its first
    step given its old map as it stood before the merge (a step left on
    the freed map's buffers); every step's pose shifted 1 mm; or every 33rd
    row its steps leave in the map's active block moved 2 cm towards the
    camera."""
    from densemonoslam_tpu_torch import step as stepmod
    from densemonoslam_tpu_torch.engine import Engine
    real_into = Engine.merge_into

    def merge_into(self, src_map, dst_map, T_ab):
        src = self.maps[src_map]
        old = (src.map_data.clone(), src.map_count.clone())
        moved = list(src.contexts)
        real_into(self, src_map, dst_map, T_ab)
        for name in moved:
            self._recompile(self.frontends[name])
            if fault is None:
                continue
            inner, calls = self.frontends[name].step_fn, [0]

            def step(state, *a, inner=inner, calls=calls, **k):
                calls[0] += 1
                if fault == "stale_map" and calls[0] == 1:
                    state = state.replace(map_data=old[0], map_count=old[1])
                new_state, stats = inner(state, *a, **k)
                if fault == "pose_shifted":
                    shift = torch.zeros_like(new_state.pose)
                    shift[0, 3] = 1e-3
                    stats = stats.clone()
                    stats[stepmod.STAT_POSE0 + 3] += 1e-3
                    new_state = new_state.replace(pose=new_state.pose + shift)
                elif fault == "rows_moved":
                    data, n = new_state.map_data, int(new_state.map_count)
                    win = min(self.config.active_window, data.shape[0] - 1)
                    rows = torch.arange(max(n - win, 0), n, 33)
                    to_cam = new_state.pose[:3, 3] - data[rows, 0:3]
                    data[rows, 0:3] += 0.02 * to_cam / to_cam.norm(dim=1, keepdim=True)
                return new_state, stats

            self.frontends[name].step_fn = step

    monkeypatch.setattr(Engine, "merge_into", merge_into)


@pytest.mark.parametrize("fault", [None, "stale_map", "pose_shifted", "rows_moved"])
def test_the_joined_step_check_follows_the_moved_camera(tmp_path, capsys, monkeypatch, fault):
    _moved_step_fault(monkeypatch, fault)
    bench = _collab(tmp_path)
    rc, out = run(bench, seed=4000000053, seconds=3.0, capsys=capsys, cell=CELL)
    assert rc == 0 and out is not None
    checks = out["checks"]
    assert out["correct"] is (fault is None), checks
    over = {k for k in JOINED
            if checks[k]["value"] is None or checks[k]["value"] > checks[k]["limit"]}
    want = {None: set(), "stale_map": {"rejoin_map_gap"},
            "pose_shifted": {"rejoin_pose_gap", "joined_step_pose_gap_median"},
            "rows_moved": {"rejoin_map_gap"}}[fault]
    assert want <= over and (fault is not None or not over), checks


def test_the_inter_map_metrics_read_a_traced_run(tmp_path, capsys):
    bench = _collab(tmp_path)
    rc, out = run(bench, seed=4000000052, seconds=3.5, trace=1, capsys=capsys, cell=CELL)
    assert rc == 0 and out is not None
    for name in ("intermap_ms", "merge_ms"):
        value = out["metrics"][name]["value"]
        assert np.isfinite(value) and value > 0.0, name


def _reader(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"test_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name: str, frame: int, parent: int, start: int, end: int):
    return types.SimpleNamespace(name=name, frame=frame, parent=parent, start_ns=start,
                                 end_ns=end, ms=(end - start) * 1e-6)


def _ctx(counters: bool, merge_spans: bool):
    """A run's context after its window, as the readers see it: two
    cameras, the recorder's spans of one query that merged (or not), the
    frames handed over before the traced span and those with a query."""
    ms = 1_000_000
    recs = [_span("frame", 10, -1, 0, 200 * ms), _span("loop.intermap", 10, 0, 10 * ms, 150 * ms)]
    if merge_spans:
        recs += [_span("merge.maps", 10, 1, 20 * ms, 40 * ms),
                 _span("merge.compact", 10, 1, 40 * ms, 60 * ms),
                 _span("merge.members", 10, 1, 60 * ms, 70 * ms)]
    recs += [_span("frame", 11, -1, 200 * ms, 210 * ms), _span("frame", 12, -1, 210 * ms, 900 * ms),
             _span("frame.dense_step", 12, len(recs) + 1, 220 * ms, 880 * ms)]
    fields = {"intermap_checks": 1, "intermap_merges": 1} if counters else {}
    frontends = {"cam0": types.SimpleNamespace(**fields), "cam1": types.SimpleNamespace(**fields)}
    st = {"on": True, "kept": {10, 11, 12}, "probed": set(), "recs": recs, "stages": {}}
    return types.SimpleNamespace(frontends=frontends, probes={
        "spans": st, "intermap_frames": {10: "cam1", 11: "cam0", 12: "cam1"},
        "intermap_queries": {10} if counters else set()})


@pytest.mark.parametrize("counters,merge_spans", [(True, True), (False, True), (True, False)],
                         ids=["this_program", "no_counters", "no_merge_spans"])
def test_the_inter_map_readers_read_nothing_on_a_program_without_them(counters, merge_spans):
    ctx = _ctx(counters, merge_spans)
    intermap, merge = _reader("intermap_ms").read(ctx), _reader("merge_ms").read(ctx)
    if counters and merge_spans:
        # the query less its merge, and the merge's spans plus camera 1's next step
        assert intermap == pytest.approx(140.0 - 50.0)
        assert merge == pytest.approx(50.0 + 660.0)
    elif counters:
        assert intermap == pytest.approx(140.0) and merge is None
    else:
        assert intermap is None and merge is None
