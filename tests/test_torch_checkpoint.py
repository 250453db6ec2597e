"""Checkpoint and resume on the PyTorch port (CPU): a resumed session
continues bit-exactly, and the `.npz` files cross between the packages in
both directions (same keys, the JAX package's dtypes).

Config: `tests/test_checkpoint_cli.py`'s (160x120 synthetic orbit, 1<<17-row
map, open loop, no NID keyframing), 8 frames, a checkpoint, 8 more."""

import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.engine import Engine as JEngine
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.ops import preprocess

torch.set_num_threads(2)

CFG = dict(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
           open_loop=True)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=24, radius=0.35, max_angle=0.3)


def _run(eng, seq, lo, hi):
    for i in range(lo, hi):
        rgb, depth = seq.frame(i)
        eng.process_frame("cam0", rgb, depth, float(i))


def _engine(seq):
    eng = Engine(seq.camera, EngineConfig(**CFG), device="cpu")
    eng.frontend("cam0").pose = seq.gt_pose(0).astype(np.float32)
    return eng


def _pose_gap(a, b):
    """(translation m, rotation rad) between two camera-to-world poses."""
    dT = np.linalg.inv(b) @ a
    return np.linalg.norm(dT[:3, 3]), np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))


@pytest.fixture(scope="module")
def port_runs(seq, tmp_path_factory):
    """An uninterrupted 16-frame run, and a run checkpointed at frame 8 (with
    a fern database holding one keyframe) then resumed in a fresh engine."""
    eng_a = _engine(seq)
    _run(eng_a, seq, 0, 16)

    eng_b = _engine(seq)
    _run(eng_b, seq, 0, 8)
    fe = eng_b.frontends["cam0"]
    cfg = eng_b.config
    rgb, depth = seq.frame(7)
    rgb_t, depth_t = torch.from_numpy(rgb), torch.from_numpy(depth)
    fe.fern_state = tloops.make_fern_state(fe.camera, cfg, device="cpu")
    fe.fern_state, _, _, _ = tloops.update_ferns(
        fe.fern_state, rgb_t, depth_t, preprocess.rgb_to_intensity(rgb_t), fe.state.pose,
        eng_b.global_tick, cfg.fern_thresh, factor=tloops.fern_factor(cfg),
        max_capacity=cfg.fern_db_max,
    )
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    eng_b.save_checkpoint("cam0", ckpt)

    eng_c = _engine(seq)
    eng_c.load_checkpoint("cam0", ckpt)
    resumed_tick = eng_c.frontends["cam0"].tick
    _run(eng_c, seq, 8, 16)
    return dict(a=eng_a, b=eng_b, c=eng_c, ckpt=ckpt, resumed_tick=resumed_tick)


def test_checkpoint_resume_bit_exact(port_runs):
    """Mirror of `test_checkpoint_resume_bit_exact`: pose within 1e-6, the
    same surfel count, 16 trajectory entries; the fern database comes back."""
    a, b, c = (port_runs[k].frontends["cam0"] for k in "abc")
    assert port_runs["resumed_tick"] == 8
    np.testing.assert_allclose(c.pose, a.pose, atol=1e-6)
    assert port_runs["c"].surfel_count("cam0") == port_runs["a"].surfel_count("cam0")
    assert len(c.trajectory) == 16
    assert port_runs["c"].global_tick == 16
    for x, y in zip(c.fern_state.db + c.fern_state.coder, b.fern_state.db + b.fern_state.coder):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_jax_loads_port_checkpoint(seq, port_runs):
    """The JAX package loads the port's file: every array equal to the
    port's at the save (state, fern DB and coder, logs), in the JAX dtypes;
    the empty fern rows keep time -1."""
    b = port_runs["b"].frontends["cam0"]
    jeng = JEngine(seq.camera, JCfg(**CFG))
    jeng.frontend("cam0")
    jeng.load_checkpoint("cam0", port_runs["ckpt"])
    jfe = jeng.frontends["cam0"]
    assert jfe.tick == 8 and jeng.global_tick == 8
    for k, v in tstep.state_to_numpy(b.state).items():
        got = np.asarray(getattr(jfe.state, k))
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    for name, ours, theirs in (("db", b.fern_state.db, jfe.fern_state.db),
                               ("coder", b.fern_state.coder, jfe.fern_state.coder)):
        for k in ours._fields:
            got, want = np.asarray(getattr(theirs, k)), getattr(ours, k).numpy()
            assert np.array_equal(got, want), (name, k)
            assert got.dtype == (np.int32 if want.dtype == np.int64 else want.dtype), (name, k)
    times = np.asarray(jfe.fern_state.db.times)
    assert int(jfe.fern_state.db.count) == 1 and times[0] == 8.0 and (times[1:] == -1).all()
    assert np.array_equal(np.asarray(jfe.pose_hist[:8]), b.pose_hist[:8].numpy())
    assert np.array_equal(np.asarray(jfe.hist_times[:8]), b.hist_times[:8].numpy())
    assert jfe.ts_log == b.ts_log
    assert np.array_equal(np.stack([np.asarray(s) for s in jfe.stats_log]),
                          torch.stack(b.stats_log).numpy())


def test_port_resumes_jax_checkpoint(seq, tmp_path):
    """The JAX engine runs 16 frames and saves at frame 8; the port loads
    that file and runs frames 8-15.  Every pose of the resumed half within
    0.5 mm and 1e-3 rad of the JAX run's, surfel counts within 1% (the
    tolerance of `tests/test_torch_step.py`'s 10-frame parity)."""
    jeng = JEngine(seq.camera, JCfg(**CFG))
    jeng.frontend("cam0")
    jeng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    ckpt = str(tmp_path / "jax.npz")
    for i in range(16):
        rgb, depth = seq.frame(i)
        jeng.process_frame("cam0", rgb, depth, float(i))
        if i == 7:
            jeng.save_checkpoint("cam0", ckpt)
    jtraj = [p for _, p in jeng.frontends["cam0"].trajectory]

    eng = _engine(seq)
    eng.load_checkpoint("cam0", ckpt)
    fe = eng.frontends["cam0"]
    assert fe.tick == 8 and fe.state.tick.dtype == torch.int64
    _run(eng, seq, 8, 16)
    traj = [p for _, p in fe.trajectory]
    assert len(traj) == 16
    for i in range(16):
        dt, dr = _pose_gap(traj[i], jtraj[i])
        assert dt < 5e-4 and dr < 1e-3, (i, dt, dr)
    jn, tn = jeng.surfel_count("cam0"), eng.surfel_count("cam0")
    assert abs(tn - jn) <= 0.01 * jn


def test_old_checkpoint_fallbacks(seq, port_runs, tmp_path):
    """A file from an older build: a missing state field keeps the fresh
    default, missing `hist_times` become frame indices, and 13-column stats
    rows are padded with the pose history."""
    z = dict(np.load(port_runs["ckpt"]))
    del z["state_consec_bad"], z["hist_times"]
    z["stats_log"] = z["stats_log"][:, :tstep.N_STATS]
    old = str(tmp_path / "old.npz")
    np.savez(old, **z)
    eng = _engine(seq)
    eng.load_checkpoint("cam0", old)
    fe = eng.frontends["cam0"]
    assert int(fe.state.consec_bad) == 0 and fe.state.consec_bad.dtype == torch.int64
    assert fe.hist_times[:8].tolist() == list(range(8))
    stats = torch.stack(fe.stats_log).numpy()
    assert stats.shape == (8, tstep.N_STATS_TOTAL)
    np.testing.assert_array_equal(stats[:, tstep.STAT_POSE0:], z["pose_log"].reshape(8, 16))
    _run(eng, seq, 8, 9)  # a new full-width row stacks onto the padded ones
    assert torch.stack(fe.stats_log).shape == (9, tstep.N_STATS_TOTAL)
