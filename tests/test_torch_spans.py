"""The port's tracing on the CPU (`utils/timer.py`): the span tree and its
frame ids over engine frames with loop checks and over a monocular run
with the sparse tracker and its flushes; a recorder that is off records
nothing and still opens the profiler ranges; the spans' clock against the
profiler's Chrome trace; the step's stage stamps against the stats row;
and the loop-check counter.  Imports nothing of the JAX package."""

from __future__ import annotations

import json
import os
import statistics
from collections import Counter

import numpy as np
import pytest
import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.models.depthnet import DepthPredictor
from densemonoslam_tpu_torch.utils import timer

from torch_closed_loop import history_run

torch.set_num_threads(2)

# the monocular slice of `tests/test_torch_hybrid.py`
MONO = dict(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
            open_loop=True, orb_tracking=True, predict_depth=True, hybrid_loops=True)
# RGB-D with loop checks from the fourth frame on, NID keyframing on
LOOPS = dict(max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, loop_check_interval=4,
             time_delta=2, confidence_threshold=1.0)


@pytest.fixture
def recorder():
    timer.reset()
    timer.enable()
    yield
    timer.enable(False)
    timer.reset()


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


def _run(seq, cfg, frames, depth=True):
    eng = Engine(seq.camera, EngineConfig(**cfg), device="cpu")
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    if cfg.get("predict_depth"):
        eng.set_depth_predictor(DepthPredictor.pretrained_synthetic(device="cpu"))
    for i in range(frames):
        rgb, d = seq.frame(i)
        eng.process_frame("cam0", rgb, d if depth else None, float(i), sync=False)
    return eng, fe


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def _check_tree(recs):
    """Every span lies inside its parent and carries its parent's frame id;
    each root is a `frame`."""
    for r in recs:
        assert r.end_ns >= r.start_ns, r
        if r.parent < 0:
            assert r.name == "frame", r
            continue
        p = recs[r.parent]
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (p, r)
        assert r.frame == p.frame, (p, r)


def test_span_tree_over_rgbd_frames_with_loop_checks(seq, recorder):
    eng, fe = _run(seq, LOOPS, 13)
    recs = timer.spans()
    _check_tree(recs)
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].frame for i in roots] == list(range(13))  # the session ticks
    for i in roots:
        kids = _children(recs, i)
        assert kids[:2] == ["frame.upload", "frame.dense_step"] and "frame.pace" in kids, kids
    checks = [r for r in recs if r.name == "loop.check"]
    assert len(checks) == fe.loop_checks == 3  # ticks 4, 8 and 12
    assert [c.frame for c in checks] == [3, 7, 11]
    assert all(recs[c.parent].name == "frame" for c in checks)
    names = Counter(r.name for r in recs)
    assert names["loop.render_inactive"] == 3 and names["loop.ferns"] == 3
    # each gate's read is a `host.read` inside a `loop.*` stage, and the
    # step's branch reads are `host.read`s inside `frame.dense_step`
    parents = Counter(recs[r.parent].name for r in recs if r.name == "host.read")
    assert parents["loop.render_inactive"] == 3
    assert set(parents) <= {"frame.dense_step", "loop.render_inactive", "loop.track",
                            "loop.optimise", "loop.hybrid_optimise"}, parents
    assert parents["frame.dense_step"] >= 13  # the render branch's read, each frame
    assert fe.loop_checks >= fe.loops_closed


def test_loop_checks_count_every_attempt_and_bound_the_closures(tmp_path, recorder):
    """The closed-loop scenario closes a loop: each `try_local_loop` call is
    one `loop.check` span and one count, and `loops_closed` never passes
    `loop_checks`."""
    history_run(str(tmp_path), "spans", False, "cpu")
    recs = timer.spans()
    checks = [r for r in recs if r.name == "loop.check"]
    applied = [r for r in recs if r.name == "loop.apply"]
    assert len(applied) >= 1 and len(checks) >= len(applied)
    assert all(recs[a.parent].name == "loop.check" for a in applied)
    _check_tree(recs)


def test_span_tree_over_a_monocular_run_with_flushes(seq, recorder):
    eng, fe = _run(seq, MONO, 10, depth=False)
    recs = timer.spans()
    _check_tree(recs)
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    assert len(by_name["frame.depth_cnn"]) == 10
    assert all(r.events is None and timer.device_ms(r) is None for r in by_name["frame.depth_cnn"])
    tracks = by_name["frame.sparse_track"]
    assert len(tracks) == 10
    for r in by_name["sparse.detect"]:
        assert recs[r.parent].name == "frame.sparse_track"
    assert len(by_name["sparse.match_pose"]) == 9  # every frame after the first
    flushes = by_name["sparse.flush"]
    assert len(flushes) == 2  # every fourth tracked frame
    assert all(recs[f.parent].name == "frame.sparse_track" for f in flushes)
    assert [f.frame for f in flushes] == [4, 8]
    stages = {recs[r.parent].name for r in recs if r.name.startswith("sparse.")
              and r.name not in ("sparse.detect", "sparse.match_pose", "sparse.flush")}
    assert stages == {"sparse.flush"}, stages
    # the pipeline lags one interval: the first flush has no batch yet
    assert [r.frame for r in by_name["sparse.keyframes"]] == [8]
    reads = [r for r in by_name["host.read"] if recs[r.parent].name.startswith("sparse.")]
    assert {recs[r.parent].name for r in reads} >= {"sparse.keyframes"}
    assert fe.loop_checks >= fe.loops_closed


def test_a_recorder_that_is_off_records_nothing_and_opens_the_ranges(seq):
    timer.reset()
    assert not timer.enabled()
    eng, fe = _run(seq, LOOPS, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.process_frame("cam0", *seq.frame(2), 2.0, sync=False)
    assert timer.spans() == []
    names = {e.name for e in prof.events()}
    assert {"frame", "frame.upload", "frame.dense_step", "frame.pace", "host.read"} <= names


def test_the_spans_clock_is_the_chrome_traces_plus_one_offset(seq, recorder, tmp_path):
    """The trace's `user_annotation` events are the spans, by name and in
    order, and each starts within 50 us of its span's start plus one offset
    for the whole trace (`PERF.md` §3)."""
    eng, fe = _run(seq, LOOPS, 2)
    timer.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(2, 5):
            eng.process_frame("cam0", *seq.frame(i), float(i), sync=False)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    # by start, an enclosing span before the spans it holds
    events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    recs = sorted(timer.spans(), key=lambda r: (r.start_ns, r.start_ns - r.end_ns))
    assert [e["name"] for e in events] == [r.name for r in recs]
    gaps = [float(e["ts"]) * 1e3 - r.start_ns for e, r in zip(events, recs)]
    offset = statistics.median(gaps)
    assert max(abs(g - offset) for g in gaps) < 50e3, (offset, gaps)


def test_stage_stamps_on_the_op_by_op_step(seq, recorder):
    """Render and fuse stamps only for the frames whose branch ran (the
    stats row's fused flag), every stamp of a frame in stage order, and the
    stage times joined to the frames by tick."""
    eng, fe = _run(seq, dict(LOOPS, open_loop=True), 10)
    fused = {k for k, row in enumerate(fe.stats_log) if float(row[stepmod.STAT_FUSED]) > 0}
    assert 0 < len(fused) < 10  # NID keyframing leaves some frames unfused
    st = eng.stage_ms("cam0")
    assert [k for k, _ in st["track"]] == list(range(10))
    assert [k for k, _ in st["step"]] == list(range(10))
    assert {k for k, _ in st["fuse"]} == fused
    rendered = {k for k, _ in st["render"]}
    assert fused <= rendered
    assert all(ms >= 0 for stage in st.values() for _, ms in stage)
    ring = eng._stages["cam0"].read()
    for k in range(10):
        t, tag = ring[k, :, 0], ring[k, :, 1]
        ran = tag == k
        assert ran[[0, 1, 6]].all() and ran[2] == ran[5] == (k in rendered)
        assert ran[3] == ran[4] == (k in fused)
        taken = t[ran]
        assert (np.diff(taken) >= 0).all(), (k, t, tag)
    # the frame spans carry the same ticks as the stamps
    frames = [r.frame for r in timer.spans() if r.name == "frame"]
    assert frames == list(range(10))


def test_stage_ring_reads_only_stamps_of_one_frame():
    """`StageRing.intervals`: a frame counts for two slots only where both
    carry its tick; a row that a later tick (past the ring's length) took
    over in part reads as neither frame, and whole frames read by tick."""
    n = timer.RING_FRAMES
    ring = timer.StageRing(3)
    assert ring.read() is None and ring.intervals(0, 2) == []

    def stamp(k, slots):
        for s in slots:
            ring.stamp(s, torch.tensor(k, dtype=torch.int64))

    stamp(5, (0, 1, 2))
    stamp(n + 5, (0,))  # the same row: slot 0 taken over, slots 1 and 2 stale
    stamp(3, (0, 2))
    stamp(2 * n + 3, (0, 1, 2))  # row 3 wholly taken over
    stamp(1, (0, 1))
    a = ring.read()
    assert a[5, 0, 1] == n + 5 and a[5, 1, 1] == a[5, 2, 1] == 5
    assert [k for k, _ in ring.intervals(0, 2, a)] == [2 * n + 3]
    assert [k for k, _ in ring.intervals(0, 1, a)] == [1, 2 * n + 3]
    assert [k for k, _ in ring.intervals(1, 2, a)] == [5, 2 * n + 3]
    assert all(ms >= 0 for _, ms in ring.intervals(0, 1, a) + ring.intervals(1, 2))
    with pytest.raises(ValueError):
        ring.stamp(0, torch.tensor(1.0))
