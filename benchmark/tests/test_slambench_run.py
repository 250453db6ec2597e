"""The harness end to end on the CPU at 160x120 (RGB-D) and 256x80
(monocular): a configuration, a cell and a per-layer metric dropped into a
copy are found by name with no file edited; a sound run is `correct`; and
a run whose timed path is broken underneath is not (the step returns its
state unchanged; the tracked pose is altered where the step produces it;
3% of the map's rows dropped or moved 2 cm where the step writes them;
K2's deformed rows moved 1 mm; the predicted depth altered where the CNN
produces it; the local bundle adjustment's poses moved 1 mm where it
solves them).  The tiny RGB-D copy's loop gates are loose, so that its
short window closes loops.  The card's own look is skipped
(`main(device="cpu")`)."""

from __future__ import annotations

import pytest
import torch

from slambench_tiny import MONO_CELL, make_copy, run

torch.set_num_threads(2)


@pytest.fixture
def bench(tmp_path):
    return make_copy(tmp_path, extra_metric="frames_in_span")


def test_added_files_are_found_by_name_and_a_sound_run_is_correct(bench, capsys):
    rc, out = run(bench, seed=4000000007, trace=1, capsys=capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # the dropped-in metric was read; CPU runs carry no device metric
    assert out["metrics"]["frames_in_span"]["value"] > 0
    assert list(out)[-1] == "checks"
    for name in ("start_pose_gap", "start_map_gap", "window_step_pose_gap_median", "closure_gap"):
        assert out["checks"][name]["value"] <= out["checks"][name]["limit"]


START_LAST = 23  # the tick of the start check's last frame (24 frames)


def _plant_in_map(data, count, pose, kind):
    """3% of the live rows, where the step has just written them: a block
    dropped (confidence 0), or every 33rd row moved 2 cm towards the
    camera."""
    n = int(count)
    if kind == "dropped_rows":
        data[n // 2: n // 2 + 3 * n // 100, 3] = 0.0
    else:
        rows = torch.arange(0, n, 33)
        to_cam = pose[:3, 3] - data[rows, 0:3]
        data[rows, 0:3] += 0.02 * to_cam / to_cam.norm(dim=1, keepdim=True)


def _broken_step(kind):
    from densemonoslam_tpu_torch import step as stepmod

    real_make = stepmod.make_device_step

    def make(*a, **k):
        real = real_make(*a, **k)

        def step(state, rgb, depth_raw, in_pose, use_in_pose, weight_mult, cluster_id=0.0):
            if kind == "unchanged":
                stats = torch.cat([torch.zeros(stepmod.N_STATS, device=state.pose.device),
                                   state.pose.reshape(-1)])
                return state, stats
            new_state, stats = real(state, rgb, depth_raw, in_pose, use_in_pose, weight_mult,
                                    cluster_id)
            if kind == "altered_pose":
                stats = stats.clone()
                stats[stepmod.STAT_POSE0 + 3] += 1e-3  # 1 mm in x, where the step produces it
            elif int(state.tick) == START_LAST:
                _plant_in_map(new_state.map_data, new_state.map_count, new_state.pose, kind)
            return new_state, stats

        return step

    return make


@pytest.mark.parametrize("kind", ["unchanged", "altered_pose", "dropped_rows", "moved_rows"])
def test_a_broken_timed_path_is_not_correct(bench, capsys, monkeypatch, kind):
    from densemonoslam_tpu_torch import step as stepmod

    monkeypatch.setattr(stepmod, "make_device_step", _broken_step(kind))
    rc, out = run(bench, seed=4000000008, capsys=capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is False
    if kind in ("dropped_rows", "moved_rows"):  # the map's comparison sees it
        gap = out["checks"]["start_map_gap"]
        assert gap["value"] is None or gap["value"] > gap["limit"], gap


def test_a_broken_deformation_is_not_correct(bench, capsys, monkeypatch):
    """K2's rows moved 1 mm where it deforms them: the closure's reading."""
    from densemonoslam_tpu_torch.ops import deform

    real = deform.deform_map

    def broken(data, count, graph):
        out = real(data, count, graph)
        out[: int(count), 0] += 1e-3
        return out

    monkeypatch.setattr(deform, "deform_map", broken)
    rc, out = run(bench, seed=4000000012, capsys=capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is False
    gap = out["checks"]["closure_gap"]
    assert gap["value"] is not None and gap["value"] > gap["limit"], gap


@pytest.mark.parametrize("fault", [None, "depth", "ba"])
def test_the_monocular_cell_on_the_cpu(bench, capsys, monkeypatch, fault):
    """Sound: correct; the depth CNN's output scaled by 1.001 where it is
    produced, or the local BA's poses moved 1 mm where it solves them: not
    correct."""
    if fault == "depth":
        from densemonoslam_tpu_torch.models import depthnet

        real = depthnet.DepthPredictor.predict
        monkeypatch.setattr(depthnet.DepthPredictor, "predict",
                            lambda self, rgb: real(self, rgb) * 1.001)
    elif fault == "ba":
        from densemonoslam_tpu_torch.parallel import ba

        real_ba = ba.bundle_adjust

        def broken(problem, *a, **k):
            out, err = real_ba(problem, *a, **k)
            poses = out.poses.clone()
            poses[:, 0, 3] += 1e-3
            return out._replace(poses=poses), err

        monkeypatch.setattr(ba, "bundle_adjust", broken)
    rc, out = run(bench, seed=4000000009, seconds=5.0, capsys=capsys, cell=MONO_CELL)
    assert rc == 0 and out is not None
    assert out["correct"] is (fault is None), out["checks"]
    if fault == "ba":
        assert out["checks"]["ba_pose_gap"]["value"] > out["checks"]["ba_pose_gap"]["limit"]
