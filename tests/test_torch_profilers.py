"""The profiling twins (`examples/torch_profile_*.py`) on the CPU at tiny
sizes: each runs with `--platform cpu` and prints or returns the stage names
of the JAX script it twins, read from that script with `ast`.  The mono
profiler at 1024x320 does not fit this file's time on a CPU, so its parts
are held instead: the `staged` wrapper's attribution on a stub tracker, and
the stage names its instrumentation installs."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _string_args(script: str, call: str) -> list:
    """The string literals passed first to every `call(...)` in a script."""
    tree = ast.parse((EXAMPLES / script).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "id", None) or getattr(node.func, "attr", None)
            if name == call and node.args and isinstance(node.args[0], ast.Constant):
                out.append(node.args[0].value)
    return out


def _out_keys(script: str) -> list:
    """The string keys of every `out["..."] = ...` in a script."""
    tree = ast.parse((EXAMPLES / script).read_text())
    return [t.slice.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
            for t in node.targets
            if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "out"
            and isinstance(t.slice, ast.Constant)]


def test_profile_stages_twin():
    """`torch_profile_stages.py --platform cpu` at 64x48: exit 0 and one row
    per stage of `profile_stages.py`, in its order, then the port's added
    row, the graphed full step (not measured on the CPU)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_profile_stages.py"), "--platform", "cpu",
         "--width", "64", "--height", "48", "--frames", "4"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [line[:20].strip() for line in proc.stdout.splitlines()[1:] if line.strip()]
    want = _out_keys("profile_stages.py")
    assert want == ["preprocess", "model_pyramid", "track_gn", "splat_render", "fuse+place",
                    "nid", "FULL_STEP"]
    assert rows[:len(want) + 2] == [*want, "full step (graphed)", "sum(stages)"]
    assert "device ms: not measured (CPU)" in proc.stdout and "platform=cpu" in proc.stdout


def test_profile_closure_twin(capsys):
    """`torch_profile_closure.main` on a 1<<15-row map at 160x120: every
    stage of `profile_closure.py`, timed, and the graph K2 would apply; the
    port's added row, the graphed GN-CG, is named and not measured on the
    CPU."""
    mod = _example("torch_profile_closure")
    res = mod.main(["--platform", "cpu"], n_surfels=1 << 14, capacity=1 << 15, width=160,
                   height=120, reps=1)
    want = _string_args("profile_closure.py", "timed")
    assert list(res["stages"]) == want
    assert all(wall > 0 and dev is None for wall, dev in res["stages"].values())
    out = capsys.readouterr().out
    assert all(name in out for name in want) and "closure (loops.try_local_loop)" in out
    assert "GN-CG (graphed)" in out and "GN-CG (graphed)" not in res["stages"]
    state = mod.build_state(1 << 12, 1 << 13, 160, 120, device="cpu")
    assert int(state.map_count) == 1 << 12
    assert int((state.map_data[:, 12] == 10.0).sum()) == 1 << 11  # the inactive half


def test_profile_micro_twin():
    """`torch_profile_micro.main` at 64x48: every case of `profile_micro.py`,
    each a CPU time per call."""
    mod = _example("torch_profile_micro")
    res = mod.main(["--platform", "cpu"], height=48, width=64, n_win=1 << 12, iters=2)
    assert list(res) == _out_keys("profile_micro.py")
    assert all(v > 0 for v in res.values())


def test_profile_render_twin():
    """`torch_profile_render.main` at 64x48: the phases of
    `profile_render.py`, the packed-key z-buffer and `render` itself."""
    mod = _example("torch_profile_render")
    res = mod.main(["--platform", "cpu"], width=64, height=48, reps=1)
    want = _string_args("profile_render.py", "timeit")
    assert [k for k in res if k.startswith("phase") and not k.startswith("phase1p")] == want
    assert {"phase1p packed-key scatter-min", "render (ACTIVE, windowed)"} <= set(res)
    assert all(v > 0 for v in res.values())


def test_profile_mono_staged_attribution():
    """`Stages.staged` on a stub tracker: each stage's wall time excludes
    the stages it calls, calls are counted, and a stage that raises is
    still attributed; the CPU run never synchronises a card."""
    mod = _example("torch_profile_mono")
    stages = mod.Stages("cpu")

    class Stub:
        def detect(self):
            return 1

        def track(self):
            return self.detect() + 1

    st = Stub()
    st.detect = stages.staged("sparse_detect", st.detect)
    st.track = stages.staged("sparse_track_total", st.track)
    assert [st.track() for _ in range(3)] == [2, 2, 2]
    assert dict(stages.calls) == {"sparse_detect": 3, "sparse_track_total": 3}
    assert all(t >= 0 for t in stages.times.values()) and not stages.active

    def fails():
        raise ValueError("x")

    with pytest.raises(ValueError):
        stages.staged("flush_batch", fails)()
    assert stages.calls["flush_batch"] == 1 and not stages.active


def test_profile_mono_instruments_the_reference_stages():
    """`instrument` wraps the stages `profile_mono.py` wraps, under the same
    names, and `undo` restores `loops.apply_hybrid_loop`."""
    mod = _example("torch_profile_mono")
    from densemonoslam_tpu_torch import loops as loopsmod

    class Stub:
        def __getattr__(self, name):
            return lambda *a, **k: None

    eng, fe = Stub(), Stub()
    eng._depth_predictor = Stub()
    fe.sparse_tracker = Stub()
    stages = mod.Stages("cpu")
    orig = loopsmod.apply_hybrid_loop
    undo = mod.instrument(eng, fe, stages)
    try:
        calls = [eng._depth_predictor.predict, fe.sparse_tracker.detect, fe.sparse_tracker.track,
                 fe.sparse_tracker.flush, fe.sparse_tracker._process_batch,
                 fe.sparse_tracker._advance_async, fe.step_fn]
        for fn in calls:
            fn()
        assert loopsmod.apply_hybrid_loop is not orig
    finally:
        undo()
    assert loopsmod.apply_hybrid_loop is orig
    assert sorted(stages.calls) == sorted(
        n for n in _string_args("profile_mono.py", "staged") if n != "hybrid_loop")
    assert np.isfinite(list(stages.times.values())).all()
