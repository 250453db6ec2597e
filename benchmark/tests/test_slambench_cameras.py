"""The harness's hand-over on the CPU at 160x120: a cell of one camera
hands over what it always did; a configuration of two ``cameras`` takes
turns tick by tick with each camera's ``offset`` and ``join`` from the
cell's ``per_camera``, and `failed` counts both cameras' frames; an
open-loop cell is `correct`, and on a schedule `handover_lag_ms` reads a
number; a trajectory named by a file dropped into ``traffic/`` is found.
The card's own look is skipped (`main(device="cpu")`)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench_tiny import CELL, make_copy, metric_entry, run

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from traffic.camera import CameraConfig, CameraIntrinsics, FrameResolution  # noqa: E402
from traffic.orbit import SyntheticSequence  # noqa: E402

torch.set_num_threads(2)

TINY_CAMERA = CameraConfig(FrameResolution(160, 120), CameraIntrinsics(132.0, 132.0, 79.5, 59.5))
LAP, WARMUP = 40, 45


def _lap_of(seq) -> dict:
    """The lap frames each colour image is (the orbit's last frame looks
    as its first does), by the image's bytes."""
    lap: dict = {}
    for i in range(LAP):
        lap.setdefault(seq.frame(i)[0].tobytes(), set()).add(i)
    return lap


def _same(recorded: list, lap: dict, want: list) -> bool:
    """Whether `recorded` hands over `want`: (camera, lap frame, timestamp)."""
    return len(recorded) == len(want) and all(
        name == w_name and w_i in lap[rgb] and ts == w_ts
        for (name, rgb, ts), (w_name, w_i, w_ts) in zip(recorded, want))


@pytest.fixture
def recorded(monkeypatch):
    """(camera, lap frame, timestamp) of every frame handed to
    `Engine.process_frame`, the lap frame told by its colour image."""
    from densemonoslam_tpu_torch.engine import Engine

    calls, real = [], Engine.process_frame

    def process_frame(self, name, rgb, depth_raw, timestamp, *a, **k):
        calls.append((name, rgb.tobytes(), timestamp))
        return real(self, name, rgb, depth_raw, timestamp, *a, **k)

    monkeypatch.setattr(Engine, "process_frame", process_frame)
    return calls


def _add(tmp_path: Path, bench: Path, config: dict, cell: dict, metrics=()) -> None:
    """A configuration and a cell dropped into the copy, with the cell in
    `BENCHMARK.json` and the per-layer `metrics` ((name, better) of readers
    under `metrics/`) listing it alone."""
    (bench / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (bench / "workloads" / f"{cell['name']}.json").write_text(json.dumps(cell))
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": cell["name"], "config": config["name"],
                              "traffic": cell["name"].split(".", 1)[1], "chips": 1,
                              "why": "the tests' small copy"})
    names = {name for name, _ in metrics}
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] not in names]
    spec["per_layer"] += [metric_entry(bench, name, better, [cell["name"]])
                          for name, better in metrics]
    spec_path.write_text(json.dumps(spec))


def _tiny(bench: Path, **engine) -> tuple:
    """The tiny RGB-D configuration and cell of the copy, as dicts."""
    config = json.loads((bench / "configs" / "tiny_rgbd.json").read_text())
    config["engine"].update(engine)
    cell = json.loads((bench / "workloads" / f"{CELL}.json").read_text())
    return config, cell


def test_one_camera_hands_over_what_it_always_did(tmp_path, capsys, recorded):
    bench = make_copy(tmp_path)
    rc, out = run(bench, seed=4000000031, seconds=2.0, capsys=capsys)
    assert rc == 0 and out is not None
    lap = _lap_of(SyntheticSequence(camera=TINY_CAMERA, num_frames=LAP, radius=0.35, max_angle=0.3))
    # the set-up's frames and then the window's, lap frame j % 40 at
    # timestamp j, all to the one camera
    n = WARMUP + out["attempted"]
    assert _same(recorded, lap, [("cam0", j % LAP, float(j)) for j in range(n)])


def test_two_cameras_take_turns_and_both_count(tmp_path, capsys, recorded, monkeypatch):
    """Camera 1 starts at lap frame 20 and joins at tick 5; where its
    step produces its pose in the window, the pose is not finite: `failed`
    counts exactly those frames, and camera 0's step is still compared.
    Open loop, since a loop closure would carry the planted pose into the
    pose history's deformation."""
    from densemonoslam_tpu_torch import step as stepmod

    bench = make_copy(tmp_path)
    config, cell = _tiny(bench, open_loop=True)
    config.update(name="tiny_two", cameras=2)
    cell.update(name="tiny_two.pair", config="tiny_two", checks={"window_step": {"frames": 3,
                                                                                 "map": False}})
    cell["traffic"]["per_camera"] = [{}, {"offset": 20, "join": 5}]
    # the largest frame's gap, held to the limit the tiny cell gives its median frame's
    cell["limits"]["window_step_pose_gap"] = cell["limits"].pop("window_step_pose_gap_median")
    _add(tmp_path, bench, config, cell)
    window_tick = 2 * WARMUP - 5  # the first session tick of the window
    real_make = stepmod.make_device_step

    def make(intr, H, W, cfg, sensor_id, device):
        real = real_make(intr, H, W, cfg, sensor_id, device)

        def step(state, *a, **k):
            new_state, stats = real(state, *a, **k)
            if sensor_id == 1 and int(state.tick) >= window_tick:
                stats = stats.clone()
                stats[stepmod.STAT_POSE0] = float("nan")
            return new_state, stats

        return step

    monkeypatch.setattr(stepmod, "make_device_step", make)
    rc, out = run(bench, seed=4000000032, seconds=3.0, capsys=capsys, cell="tiny_two.pair")
    assert rc == 0 and out is not None
    lap = _lap_of(SyntheticSequence(camera=TINY_CAMERA, num_frames=LAP, radius=0.35, max_angle=0.3))
    ticks = sum(1 for name, _, _ in recorded if name == "cam0")
    want = []
    for t in range(ticks):
        want.append(("cam0", t % LAP, float(t)))
        if t >= 5:
            want.append(("cam1", (20 + t - 5) % LAP, float(t - 5)))
    assert _same(recorded, lap, want)
    window = recorded[2 * WARMUP - 5:]
    assert out["attempted"] == len(window)
    assert out["failed"] == sum(1 for name, _, _ in window if name == "cam1") > 0
    gap = out["checks"]["window_step_pose_gap"]
    assert gap["value"] is not None and gap["value"] <= gap["limit"], gap


def test_cameras_share_a_lap_that_their_mixes_share():
    from traffic import frames as framesmod

    cam = CameraConfig(FrameResolution(32, 24), CameraIntrinsics(26.4, 26.4, 15.5, 11.5))
    mix = {"trajectory": "orbit", "lap": 40, "warmup_frames": 3, "rate_hz": 30,
           "sequence": {"radius": 0.35, "max_angle": 0.3},
           "per_camera": [{}, {"offset": 20, "join": 5}, {"sequence": {"radius": 0.2}}]}
    a, b, c = framesmod.make_cameras(mix, cam, 3)
    assert a.lap_frames is b.lap_frames and c.lap_frames is not a.lap_frames
    assert (a.index(0), b.index(0), b.index(25)) == (0, 20, 5)
    assert (a.warmup, b.warmup, c.warmup) == (3, 0, 3) and b.rate_hz == 30.0
    assert np.array_equal(b.gt_pose(0), a.gt_pose(20))
    with pytest.raises(ValueError):
        framesmod.make_cameras(mix, cam, 2)


@pytest.mark.parametrize("fault", [None, "unchanged", "altered_pose"])
def test_an_open_loop_cell_on_a_schedule_is_correct(tmp_path, capsys, monkeypatch, fault):
    """The open-loop configuration's checks pass, and frames due at 20 Hz
    give `handover_lag_ms` a reading; a step that returns its state
    unchanged, or a pose altered where the step produces it, is not
    correct."""
    if fault:
        from densemonoslam_tpu_torch import step as stepmod
        from test_slambench_run import _broken_step

        monkeypatch.setattr(stepmod, "make_device_step", _broken_step(fault))
    bench = make_copy(tmp_path)
    real = json.loads((BENCH / "configs" / "rgbd_vga_odometry.json").read_text())
    config, cell = _tiny(bench)
    config.update(name="tiny_odometry")
    config["engine"] = dict(real["engine"], **{k: config["engine"][k] for k in (
        "max_surfels", "pyramid_levels", "track_row_stride")})
    odo = json.loads((BENCH / "workloads" / "rgbd_vga_odometry.lap.json").read_text())
    cell.update(name="tiny_odometry.live", config="tiny_odometry", checks=dict(odo["checks"]),
                limits=odo["limits"], trace={"start_s": 2.5, "span_s": 0.5})
    cell["checks"]["window_step"] = dict(cell["checks"]["window_step"], frames=3)
    cell["traffic"]["rate_hz"] = 20
    _add(tmp_path, bench, config, cell, metrics=(("handover_lag_ms", "lower"),))
    rc, out = run(bench, seed=4000000033, seconds=3.0, trace=1, capsys=capsys,
                  cell="tiny_odometry.live")
    assert rc == 0 and out is not None
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["checks"]) == set(odo["limits"])
    lag = out["metrics"]["handover_lag_ms"]["value"]
    assert lag == lag and lag >= 0.0


def test_a_trajectory_is_found_by_its_file(tmp_path, capsys, recorded, monkeypatch):
    bench = make_copy(tmp_path)
    (bench / "traffic" / "tight_orbit.py").write_text(
        '"""The orbit at a 0.2 m radius, whatever the mix says."""\n\n'
        "from .orbit import SyntheticSequence\n\n\n"
        "class Sequence(SyntheticSequence):\n"
        "    def __init__(self, camera, num_frames, **kw):\n"
        "        super().__init__(camera=camera, num_frames=num_frames, radius=0.2)\n")
    config, cell = _tiny(bench)
    cell.update(name="tiny_rgbd.tight", checks={"window_step": {"frames": 2, "map": False}})
    cell["traffic"]["trajectory"] = "tight_orbit"
    _add(tmp_path, bench, config, cell)
    # the copy's traffic package, not one an earlier test imported
    for mod in [m for m in sys.modules if m == "traffic" or m.startswith("traffic.")]:
        monkeypatch.delitem(sys.modules, mod)
    rc, out = run(bench, seed=4000000034, seconds=1.0, capsys=capsys, cell="tiny_rgbd.tight")
    assert rc == 0 and out is not None
    lap = _lap_of(SyntheticSequence(camera=TINY_CAMERA, num_frames=LAP, radius=0.2))
    assert recorded and all(rgb in lap for _, rgb, _ in recorded)
    assert not np.array_equal(
        SyntheticSequence(camera=TINY_CAMERA, num_frames=LAP, radius=0.35).frame(3)[0],
        SyntheticSequence(camera=TINY_CAMERA, num_frames=LAP, radius=0.2).frame(3)[0])
