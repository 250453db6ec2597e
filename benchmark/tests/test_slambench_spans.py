"""The per-layer metrics that read the program's own spans, stage stamps and
loop counters (`benchmark/spans.py`), end to end on the CPU: a `--trace 1`
run of each tiny cell reports every one of them that its cell lists, and a
`--trace 0` run reports none and leaves the recorder off.  The card's own
look is skipped (`main(device="cpu")`)."""

from __future__ import annotations

import json

import pytest
import torch

from slambench_tiny import CELL, MONO_CELL, make_copy, metric_entry, run

torch.set_num_threads(2)

NEW = {
    CELL: ("step_track_device_ms", "step_render_device_ms", "step_fuse_device_ms",
           "loop_track_ms", "loop_accept_pct"),
    MONO_CELL: ("step_track_device_ms", "step_render_device_ms", "step_fuse_device_ms",
                "depth_cnn_device_ms", "sparse_frontend_ms", "sparse_flush_ms"),
}
REAL = {CELL: "rgbd_vga_odometry.lap", MONO_CELL: "mono_kitti.street"}
# the loop layer's readers, whose cells are out of BENCHMARK.json until the
# program's tracking fault is mended (PERF.md §7): the tiny RGB-D cell lists them
LOOP = (("loop_track_ms", "lower"), ("loop_accept_pct", "higher"))


@pytest.fixture
def bench(tmp_path):
    """The tiny copy with each per-layer metric in the tiny cells of the
    real cells that list it, and the RGB-D span late enough that loop
    checks come before it."""
    bench = make_copy(tmp_path)
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    for m in spec["per_layer"]:
        real = [w for w in m["workloads"] if w in REAL.values()]
        m["workloads"] = real + [tiny for tiny, r in REAL.items() if r in real]
    spec["per_layer"] += [metric_entry(bench, name, better, [CELL]) for name, better in LOOP]
    spec_path.write_text(json.dumps(spec))
    cell_path = bench / "workloads" / f"{CELL}.json"
    cell = json.loads(cell_path.read_text())
    cell["trace"] = {"start_s": 12.0, "span_s": 1.0}
    cell_path.write_text(json.dumps(cell))
    return bench


@pytest.mark.parametrize("cell", [CELL, MONO_CELL])
def test_every_new_reader_returns_a_number(bench, capsys, cell):
    from densemonoslam_tpu_torch.utils import timer

    try:
        rc, out = run(bench, seed=4000000021, seconds=15.0, trace=1, capsys=capsys, cell=cell)
    finally:
        timer.enable(False)
        timer.reset()
    # `correct` is the sound runs' test's (`test_slambench_run.py`): this
    # short window may hold no accepted closure after the time drawn
    assert rc == 0 and out is not None
    for name in NEW[cell]:
        value = out["metrics"][name]["value"]
        assert value == value and value >= 0.0, (name, value)
    if cell == CELL:
        assert 0.0 < out["metrics"]["loop_accept_pct"]["value"] <= 100.0


def test_an_untraced_run_leaves_the_recorder_off(bench, capsys):
    from densemonoslam_tpu_torch.utils import timer

    timer.reset()
    rc, out = run(bench, seed=4000000022, seconds=3.0, capsys=capsys, cell=MONO_CELL)
    assert rc == 0 and out is not None
    assert not timer.enabled() and timer.spans() == []
    assert not set(out["metrics"]) & {n for names in NEW.values() for n in names}
