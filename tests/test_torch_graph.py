"""The step and the deformation GN-CG as device programs (`utils/graphs.py`),
held on the CPU: the eager step reads nothing back outside `graphs.branch`,
both sides of each branch leave its outputs alike, the restructured step
and tracking match the JAX package on the frames that take each branch,
`optimise` reads nothing back, and `GraphedFn` never runs on the CPU.

Configuration: `__graft_entry__.entry()`'s (96x128, 1<<14 rows, NID
keyframing, open loop, 3 levels) on the synthetic orbit, frames in `ORDER`:
frame 5 shows the orbit's frame 11 (tracking fails: a render without
fusion), frame 7 the orbit's frame 18 (both finer levels starve, for any
thread count: the orbit's frame 20 there starves one level or none,
depending on the summation order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.mapping import deformation as jdg
from densemonoslam_tpu.tracking import odometry as jodo
from densemonoslam_tpu_torch import entry as tentry
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import CameraConfig, FrameResolution
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import deformation as tdg
from densemonoslam_tpu_torch.tracking import odometry as todo
from densemonoslam_tpu_torch.utils import graphs
from test_torch_deform import _jgraph, _problem

torch.set_num_threads(2)

H, W = 96, 128
ORDER = [0, 1, 2, 3, 4, 11, 6, 18]
# the branches each frame calls, in order, and those whose body runs
LEVELS = ["starved2", "starved1", "starved0"]
CALLS_RENDER = LEVELS + ["render"]
RUNS = [
    {"starved1", "starved0", "render", "fuse"},  # first frame: empty model
    set(), {"render", "fuse"}, set(), {"render", "fuse"},
    {"render"},  # tracking failed: render, no fusion
    {"render", "fuse"},
    {"starved1", "starved0", "render", "fuse"},  # the jump: both finer levels starve
]
EXACT = [tstep.STAT_TRACK_OK, tstep.STAT_FUSED, tstep.STAT_MATCHED, tstep.STAT_ADDED,
         tstep.STAT_CULLED, tstep.STAT_SURFELS, tstep.STAT_KEYFRAMES, tstep.STAT_DROPPED]
# every way a value crosses from a tensor to the host
READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "numpy", "cpu")
BRANCH_CODE = graphs.branch.__code__  # the one place a read is allowed


@pytest.fixture(scope="module")
def case():
    """The port's step (from `entry`), the JAX step (from
    `__graft_entry__.entry`, compiled once for every JAX call here), the
    frames (rgb as f32, as `entry`'s example) and the initial state."""
    _, intr = tentry.config()
    seq = SyntheticSequence(camera=CameraConfig(FrameResolution(W, H), intr, "graph"),
                            num_frames=40, radius=0.35, max_angle=0.3)
    tfn, targs = tentry.entry(device="cpu")
    jfn, jargs = graft.entry()
    frames = []
    for f in ORDER + [20]:
        rgb, depth = seq.frame(f)
        frames.append((rgb.astype(np.float32), depth))
    init = tstep.state_to_numpy(tstep.SlamState(*targs[0]))
    init["pose"] = seq.gt_pose(0).astype(np.float32)
    return dict(tfn=tfn, jfn=jfn, frames=frames, init=init)


def _torch_step(fn, state_np, rgb, depth, tick):
    state = tstep.state_from_numpy({**state_np, "tick": np.int32(tick)}, "cpu")
    out, stats = fn(tuple(getattr(state, f) for f in tstep.STATE_FIELDS), torch.from_numpy(rgb),
                    torch.from_numpy(depth), torch.eye(4), torch.tensor(False),
                    torch.tensor(1.0), torch.tensor(0.0))
    return tstep.state_to_numpy(tstep.SlamState(*out)), stats.numpy()


def _jax_step(fn, state_np, rgb, depth, tick):
    state = tuple(jnp.asarray({**state_np, "tick": np.int32(tick)}[f]) for f in tstep.STATE_FIELDS)
    out, stats = fn(state, jnp.asarray(rgb), jnp.asarray(depth), jnp.eye(4, dtype=jnp.float32),
                    jnp.asarray(False), jnp.asarray(1.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
    return {f: np.asarray(x) for f, x in zip(tstep.STATE_FIELDS, out)}, np.asarray(stats)


@pytest.fixture(scope="module")
def jax_states(case):
    """The JAX package's state before each of the first six frames."""
    states = [case["init"]]
    for k in range(5):
        states.append(_jax_step(case["jfn"], states[-1], *case["frames"][k], k)[0])
    return states


class _NoReads:
    """Patch every tensor-to-host method to raise, except when
    `graphs.branch` itself reads its predicate."""

    def __init__(self, monkeypatch):
        self.reads = []
        for name in READS:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, real))

    def _guard(self, name, real):
        def guarded(t, *a, **k):
            caller = sys._getframe(1)
            if caller.f_code is BRANCH_CODE:
                self.reads.append(name)
                return real(t, *a, **k)
            raise AssertionError(f"host read: Tensor.{name} at "
                                 f"{caller.f_code.co_filename}:{caller.f_lineno}")
        return guarded


def test_eager_step_reads_only_in_branches(case, monkeypatch):
    """Eight frames of the eager step with every host read patched to raise
    outside `graphs.branch`: each frame calls the three levels' starvation
    branches, then the render branch, then, where render ran, the fuse
    branch inside it; the bodies that run are those of `RUNS` (fused,
    no-render, render-only and starved frames), and each call is one read
    of its predicate."""
    calls = []
    real_branch = graphs.branch

    def spy(pred, body, name):
        calls[-1].append(name)
        real_branch(pred, body, name)

    fn = case["tfn"]
    state = tstep.state_from_numpy(case["init"], "cpu")
    flat = tuple(getattr(state, f) for f in tstep.STATE_FIELDS)
    monkeypatch.setattr(graphs, "branch", spy)
    guard = _NoReads(monkeypatch)
    runs = []
    for k, (rgb, depth) in enumerate(case["frames"][: len(ORDER)]):
        calls.append([])
        before = dict(graphs.BRANCH_RUNS)
        flat = flat[:3] + (torch.full((), k, dtype=torch.int64),) + flat[4:]
        flat, stats = fn(flat, torch.from_numpy(rgb), torch.from_numpy(depth), torch.eye(4),
                         torch.tensor(False), torch.tensor(1.0), torch.tensor(0.0))
        runs.append({n for n, v in graphs.BRANCH_RUNS.items() if v != before.get(n, 0)})
    monkeypatch.undo()
    assert runs == RUNS
    for names, ran in zip(calls, runs):
        assert names == CALLS_RENDER + (["fuse"] if "render" in ran else [])
    assert len(guard.reads) == sum(len(c) for c in calls)
    assert set(guard.reads) == {"__bool__"}


@pytest.mark.parametrize("k,kind", [(1, "no-render"), (5, "starved")])
def test_step_matches_jax_step(case, jax_states, k, kind):
    """One step of both packages from the JAX package's state: frame 1 (no
    render), and orbit frame 20 after frame 4 (both of the finer levels
    starve; tracking accepts its pose).  `tests/test_torch_step.py`'s one-step
    tolerances: flags and counts exact, every stats float within rtol 1e-3
    / atol 1e-5, the state's pose and the surfel count."""
    rgb, depth = case["frames"][k if kind == "no-render" else len(ORDER)]
    before = dict(graphs.BRANCH_RUNS)
    ts, tst = _torch_step(case["tfn"], jax_states[k], rgb, depth, k)
    ran = {n for n, v in graphs.BRANCH_RUNS.items() if v != before.get(n, 0)}
    js, jst = _jax_step(case["jfn"], jax_states[k], rgb, depth, k)
    if kind == "starved":
        assert {"starved1", "starved0"} <= ran and tst[tstep.STAT_TRACK_OK] == 1
    else:
        assert "render" not in ran
    np.testing.assert_array_equal(tst[EXACT], jst[EXACT])
    np.testing.assert_allclose(tst, jst, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(ts["pose"], js["pose"], atol=1e-4)
    assert int(ts["map_count"]) == int(js["map_count"])


def test_track_matches_jax_on_a_starved_frame(case, jax_states):
    """`odometry.track` on the starved frame of the step test (the state
    after frame 4, orbit frame 20 against its stored prediction), both
    packages on the same pyramids: the finer levels' fallbacks run, and A
    agrees within 1e-4, the inlier counts within 1%, the errors within rtol
    1e-3, as `tests/test_torch_tracking.py` holds a frame pair."""
    _, intr = tentry.config()
    s = jax_states[5]
    rgb, depth = case["frames"][len(ORDER)]
    ji = JIntr(intr.fx, intr.fy, intr.cx, intr.cy)
    jm = jodo.build_model_pyramid(jnp.asarray(s["pred_intensity"]), jnp.asarray(s["pred_vmap"]),
                                  jnp.asarray(s["pred_nmap"]), 3)
    jf = jodo.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(depth), ji, 3)
    jr = jodo.track(jm, jf, jnp.asarray(s["model_rel"]), ji, iterations=(4, 5, 10))
    t = {k: torch.from_numpy(np.array(s[k]))
         for k in ("pred_intensity", "pred_vmap", "pred_nmap", "model_rel")}
    tm = todo.build_model_pyramid(t["pred_intensity"], t["pred_vmap"], t["pred_nmap"], 3)
    tf = todo.build_frame_pyramid(torch.from_numpy(rgb), torch.from_numpy(depth), intr, 3)
    before = dict(graphs.BRANCH_RUNS)
    tr = todo.track(tm, tf, t["model_rel"], intr, iterations=(4, 5, 10))
    ran = {n for n, v in graphs.BRANCH_RUNS.items() if v != before.get(n, 0)}
    assert {"starved1", "starved0"} <= ran
    assert bool(tr.failed) == bool(jr.failed) is False
    np.testing.assert_allclose(tr.A.numpy(), np.asarray(jr.A), atol=1e-4)
    np.testing.assert_allclose(float(tr.icp_inliers), float(jr.icp_inliers), rtol=0.01)
    np.testing.assert_allclose(float(tr.rgb_inliers), float(jr.rgb_inliers), rtol=0.01)
    np.testing.assert_allclose(float(tr.icp_error), float(jr.icp_error), rtol=1e-3)


def test_branch_sides_leave_outputs_alike(case, monkeypatch):
    """Every branch of the step forced to run its body, then forced to skip
    it, from the same state: the new state and the stats have the same
    shapes and dtypes either way (what lets the IF node replace the Python
    `if` on the card), and `graphs.assign` accepted every result."""
    out = {}
    for side, take in (("true", True), ("false", False)):
        monkeypatch.setattr(graphs, "branch", lambda p, body, n, take=take: body() if take else None)
        state = tstep.state_from_numpy(case["init"], "cpu")
        flat = tuple(getattr(state, f) for f in tstep.STATE_FIELDS)
        shapes = []
        for k in range(2):
            rgb, depth = case["frames"][k]
            flat, stats = case["tfn"](flat, torch.from_numpy(rgb), torch.from_numpy(depth),
                                      torch.eye(4), torch.tensor(False), torch.tensor(1.0),
                                      torch.tensor(0.0))
            shapes.append([(tuple(x.shape), x.dtype) for x in (*flat, stats)])
        out[side] = shapes
    ref = tstep.state_from_numpy(case["init"], "cpu")
    want = [(tuple(getattr(ref, f).shape), getattr(ref, f).dtype) for f in tstep.STATE_FIELDS]
    assert out["true"] == out["false"]
    assert out["true"][0][:-1] == want


def test_optimise_reads_nothing_and_matches_jax(monkeypatch):
    """GN-CG on `tests/test_torch_deform.py`'s problem with every host read
    patched to raise (through `optimise_graphed`, which is `optimise` on the
    CPU): no read, and the result holds the JAX function to that file's
    tolerances (nodes within 2e-3, stats within rtol 1e-3)."""
    g, cons, frozen, rel = _problem(np.random.default_rng(11))
    jg2, js = jdg.optimise(_jgraph(g), jdg.Constraint(**{k: jnp.asarray(v) for k, v in cons.items()}),
                           frozen=jnp.asarray(frozen),
                           rel=jdg.RelConstraint(**{k: jnp.asarray(v) for k, v in rel.items()}))
    jax.block_until_ready(jg2)
    tcons = tdg.Constraint(**{k: torch.from_numpy(v) for k, v in cons.items()})
    trel = tdg.RelConstraint(**{k: torch.from_numpy(v) for k, v in rel.items()})
    tgraph = tdg.graph_from_numpy(g, "cpu")
    _NoReads(monkeypatch)
    tg2, ts = tdg.optimise_graphed(tgraph, tcons, frozen=torch.from_numpy(frozen), rel=trel)
    monkeypatch.undo()
    np.testing.assert_allclose(tg2.A.numpy(), np.asarray(jg2.A), atol=2e-3)
    np.testing.assert_allclose(tg2.t.numpy(), np.asarray(jg2.t), atol=2e-3)
    np.testing.assert_allclose([float(x) for x in ts], [float(x) for x in js], rtol=1e-3, atol=1e-7)


def test_graphed_fn_raises_on_cpu():
    """`GraphedFn` (and the graphed step) on CPU tensors raise a
    `ValueError` that names the device; nothing runs eagerly instead."""
    fn = graphs.GraphedFn(lambda x: x * 2)
    with pytest.raises(ValueError, match="cpu"):
        fn(torch.ones(3))
    assert fn.graph is None
    cfg, intr = tentry.config()
    step = tstep.make_graphed_step(intr, H, W, cfg)
    state = tstep.init_state(16, H, W, device="cpu")
    with pytest.raises(ValueError, match="cpu"):
        step(state, torch.zeros(H, W, 3), torch.zeros(H, W), torch.eye(4), False, 1.0, 0.0)


def test_entry_matches_jax_entry(case):
    """`entry.entry(device="cpu")` against `__graft_entry__.entry()`: the
    same example arguments from `default_rng(0)`, one call each; flags and
    counts exact, every stats float within rtol 1e-3 / atol 1e-5
    (`tests/test_torch_step.py`'s one-step tolerances), the new state's
    pose and surfel count."""
    tfn, targs = tentry.entry(device="cpu")
    jfn, jargs = graft.entry()
    for a, b in zip(targs[1:], jargs[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tout, tst = tfn(*targs)
    jout, jst = jfn(*jargs)
    tst, jst = tst.numpy(), np.asarray(jst)
    np.testing.assert_array_equal(tst[EXACT], jst[EXACT])
    np.testing.assert_allclose(tst, jst, rtol=1e-3, atol=1e-5)
    i = tstep.STATE_FIELDS.index
    np.testing.assert_allclose(tout[i("pose")].numpy(), np.asarray(jout[i("pose")]), atol=1e-4)
    assert int(tout[i("map_count")]) == int(jout[i("map_count")])
