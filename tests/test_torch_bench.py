"""The port's headline benchmark `torch_bench.py` against the JAX package's
`bench.py`, and the engine's bounded pacing against the JAX engine's, on the
CPU: one `_run_slam` leg of each package on the same orbit, the JSON keys
(read from `bench.py` with `ast`, not run), the collaborative measurement
on one gloo rank, and the ticks on which each engine waits."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import torch_bench
from densemonoslam_tpu import engine as jengmod
from densemonoslam_tpu.config import EngineConfig as JEngineConfig
from densemonoslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence
from densemonoslam_tpu_torch import engine as engmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import EngineConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_engine.py's ATE bound (10 mm), here on the difference
# between the two packages' ATE over the same leg
ATE_TOL_MM = 10.0


def test_run_slam_matches_reference():
    """`torch_bench._run_slam` against `bench._run_slam` at 128x96, 2 warm-up
    + 4 timed frames, open loop, a 1<<14-row map: the same frames tracked
    and fused, the same surfel count, ATE within 10 mm of the JAX leg's, no
    closure.  The map fills at frame 2 and both packages lose frame 3 on
    this short orbit; the frames after it part by ~2 mm."""
    args = (128, 96, 4, 2, dict(open_loop=True))
    kw = dict(base_cfg=dict(max_surfels=1 << 14))
    j_fps, j_ate, j_eng, j_loops, j_ms = bench._run_slam(*args, **kw)
    t_fps, t_ate, t_eng, t_loops, t_ms = torch_bench._run_slam(*args, **kw, device="cpu")
    j_stats = np.asarray(j_eng.frontends["cam0"].stats_log)
    t_stats = torch.stack(t_eng.frontends["cam0"].stats_log).numpy()
    flags = [stepmod.STAT_TRACK_OK, stepmod.STAT_FUSED]
    np.testing.assert_array_equal(t_stats[:, flags], j_stats[:, flags])
    assert t_eng.surfel_count("cam0") == j_eng.surfel_count("cam0")
    assert abs(t_ate - j_ate) < ATE_TOL_MM, (t_ate, j_ate)
    assert (t_loops, t_ms) == (j_loops, j_ms) == (0, 0.0)
    assert t_fps > 0


def _dict_keys(node: ast.Dict) -> dict:
    """{key: nested keys or None} of a dict literal."""
    return {k.value: (_dict_keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _printed_dict(fn: ast.FunctionDef) -> dict:
    """The keys of the dict literal inside `print(json.dumps({...}))`."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return _dict_keys(node.args[0])
    raise AssertionError(f"{fn.name} prints no dict literal")


def _returned_dict(fn: ast.FunctionDef) -> dict:
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1
    return _dict_keys(ret[0].value)


def test_json_keys_match_bench():
    """`torch_bench`'s JSON line has exactly `bench.py`'s keys, `extra`'s and
    `closed_loop`'s included; the mono street block has exactly the keys of
    `bench._run_mono_street`'s result, and collab adds only the platform."""
    want = _printed_dict(_function(REPO / "bench.py", "main"))
    mono_want = _returned_dict(_function(REPO / "bench.py", "_run_mono_street"))
    mono_have = _returned_dict(_function(REPO / "torch_bench.py", "_run_mono_street"))
    assert mono_have == mono_want
    mono = dict.fromkeys(mono_have, 0)
    collab = {"cam_fps_1": 1.0, "cam_fps_8": 8.0, "scaling_efficiency": 1.0, "platform": "cpu"}
    got = torch_bench._summary(20.0, 1.0, 100, 30, 10.0, 1, 500.0, 15.0, 19.0, 12.0, mono,
                               18.0, collab)

    def keys(d):
        return {k: (keys(v) if isinstance(v, dict) and k in ("extra", "closed_loop") else None)
                for k, v in d.items()}

    assert keys(got) == want
    assert set(got["extra"]["mono_street_kitti"]) == set(mono_want)
    assert "error" not in str(keys(got))


def test_collab_one_rank():
    """The collaborative measurement on one gloo rank, 2 iterations, under
    its own time limit: a rate, on the CPU."""
    out = torch_bench._run_collab(ranks=(1,), iters=2, timeout=120)
    assert out["platform"] == "cpu" and out["cam_fps_1"] > 0
    assert set(out) == {"cam_fps_1", "platform"}


def test_main_needs_the_card():
    """`torch_bench.py` runs on the card unless asked for the CPU: without a
    card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        torch_bench.main([])


def test_bounded_pacing_fires_on_the_reference_ticks(monkeypatch):
    """The port's engine waits on the same frames as the JAX engine
    (`densemonoslam_tpu/engine.py:502-509`): every 4 frames once more than
    8 stats rows are logged, on the row 8 back.  Both engines run 21 frames
    with their step replaced by one that returns a stats row (nothing
    compiles); `engine.PACING_WAITS` counts the port's waits."""
    seq = JSyntheticSequence(num_frames=2)
    rgb, depth = seq.frame(0)
    n = 21

    jeng = jengmod.Engine(seq.camera, JEngineConfig(max_surfels=1 << 10, open_loop=True))
    jfe = jeng.frontend("cam0")
    jfe.step_fn = lambda state, *a: (state, jnp.zeros(29, jnp.float32))
    waited = []

    def block(x):
        hit = [i for i, row in enumerate(jfe.stats_log) if row is x]
        if hit:
            waited.append((jfe.tick, hit[0]))
        return x

    monkeypatch.setattr(jax, "block_until_ready", block)
    for i in range(n):
        jeng.process_frame("cam0", rgb, depth, float(i), sync=False)

    import densemonoslam_tpu_torch.io.synthetic as tsyn

    teng = engmod.Engine(tsyn.SyntheticSequence(num_frames=2).camera,
                         EngineConfig(max_surfels=1 << 10, open_loop=True), device="cpu")
    tfe = teng.frontend("cam0")
    tfe.step_fn = lambda state, *a: (state, torch.zeros(29))
    fired = []
    for i in range(n):
        before = engmod.PACING_WAITS
        teng.process_frame("cam0", rgb, depth, float(i), sync=False)
        if engmod.PACING_WAITS > before:
            fired.append(tfe.tick)
    assert [t for t, _ in waited] == fired == [12, 16, 20]
    assert [row for _, row in waited] == [t - 8 for t in fired]
    assert not tfe.frame_events  # on the CPU nothing is recorded to wait on
