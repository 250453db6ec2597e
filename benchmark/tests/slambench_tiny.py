"""A small copy of the benchmark for the tests: the real files, plus a
160x120 configuration and cell (and any extra files a test drops in) in a
temporary directory, and one run of it on the CPU."""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "tiny_rgbd.revisit_lap"
MONO_CELL = "tiny_mono.street"


def make_copy(dst: Path, extra_metric: str | None = None) -> Path:
    """`dst/BENCHMARK.json` and `dst/benchmark/` with the tiny cell added;
    returns the copy's benchmark directory."""
    bench = dst / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "rgbd_vga.json").read_text())
    cfg["name"] = "tiny_rgbd"
    cfg["camera"] = {"width": 160, "height": 120, "fx": 132.0, "fy": 132.0, "cx": 79.5, "cy": 59.5}
    # gates loose enough that most loop checks of a short CPU window close
    cfg["engine"].update(max_surfels=1 << 18, pyramid_levels=3, track_row_stride=1,
                         loop_min_inactive_frac=0.01, loop_inlier_frac=0.0, icp_count_thresh=0,
                         loop_icp_err_thresh=1.0, cov_thresh=1.0, loop_cons_err_thresh=1.0)
    (bench / "configs" / "tiny_rgbd.json").write_text(json.dumps(cfg))
    cell = json.loads((BENCH / "workloads" / "rgbd_vga.revisit_lap.json").read_text())
    cell.update(name=CELL, config="tiny_rgbd", trace={"start_s": 0.5, "span_s": 1.0})
    cell["checks"]["window_step"].update(frames=3)
    cell["checks"]["closure"].update(rows=4096)
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": CELL, "config": "tiny_rgbd", "traffic": "revisit_lap",
                              "chips": 1, "why": "the tests' small copy"})
    for m in spec["per_layer"]:
        m.get("workloads", []).append(CELL)
    mono = json.loads((BENCH / "configs" / "mono_kitti.json").read_text())
    mono["name"] = "tiny_mono"
    mono["camera"] = {"width": 256, "height": 80, "fx": 707.09 / 4, "fy": 707.09 / 4,
                      "cx": 601.89 / 4, "cy": 183.11 / 4}
    mono["engine"].update(max_surfels=1 << 18)
    (bench / "configs" / "tiny_mono.json").write_text(json.dumps(mono))
    cell = json.loads((BENCH / "workloads" / "mono_kitti.street.json").read_text())
    cell.update(name=MONO_CELL, config="tiny_mono")
    cell["traffic"].update(lap=120, warmup_frames=12)
    for name in ("depth_cnn", "sparse_window"):
        cell["checks"][name].update(frames=2)
    cell["checks"]["window_step"].update(frames=3)
    (bench / "workloads" / f"{MONO_CELL}.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": MONO_CELL, "config": "tiny_mono", "traffic": "street",
                              "chips": 1, "why": "the tests' small monocular copy"})
    # the monocular checks read the packaged weights beside the benchmark
    (dst / "densemonoslam_tpu_torch").symlink_to(ROOT / "densemonoslam_tpu_torch")
    if extra_metric:
        spec["per_layer"].append({"name": extra_metric, "unit": "frames", "better": "higher",
                                  "source": "program_counter", "layer": "engine",
                                  "moves": "fps", "workloads": [CELL]})
        (bench / "metrics" / f"{extra_metric}.py").write_text(
            'UNIT = "frames"\nLAYER = "engine"\nMOVES = "fps"\nSOURCE = "program_counter"\n\n\n'
            "def read(ctx):\n    return float(ctx.span_frames)\n")
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def metric_entry(bench: Path, name: str, better: str, cells: list) -> dict:
    """A `per_layer` entry for the reader `metrics/<name>.py` of the copy,
    from its own constants, listing `cells`."""
    spec = importlib.util.spec_from_file_location(f"tiny_metric_{name}",
                                                  bench / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"name": name, "unit": mod.UNIT, "better": better, "source": mod.SOURCE,
            "layer": mod.LAYER, "moves": mod.MOVES, "workloads": list(cells)}


def run(bench: Path, seed: int, seconds: float = 12.0, trace: int = 0, capsys=None,
        cell: str = CELL) -> tuple:
    """One run of the tiny cell on the CPU: (exit code, the result line's
    JSON or None)."""
    spec = importlib.util.spec_from_file_location("bench_run_under_test", bench / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--bench-dir", str(bench)], device="cpu")
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)
