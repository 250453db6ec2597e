"""Parity of the PyTorch port's fused per-frame step with
`densemonoslam_tpu.step.make_step`: one step from a shared mid-sequence
state, and a 10-frame run from the same initial state.

Config: 160x120 synthetic orbit, 3 pyramid levels, row stride 2, a 64K-row
map streamed through a 32K-row active window, NID keyframing on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import step as jstep
from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch import step as tstep
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.config import EngineConfig as TCfg

torch.set_num_threads(2)

H, W = 120, 160
CFG = dict(
    max_surfels=1 << 16, active_window=1 << 15, depth_cutoff=8.0, depth_factor=1.0,
    open_loop=True, nid_keyframing=True, pyramid_levels=3, track_row_stride=2,
)
N_FRAMES = 10
SHARED = 5  # the state after this frame seeds the one-step test
EYE = np.eye(4, dtype=np.float32)


def _jax_state(d):
    return jstep.SlamState(**{k: jnp.asarray(v) for k, v in d.items()})


def _jax_call(fn, state, rgb, depth, tick):
    state = state._replace(tick=jnp.asarray(tick, jnp.int32))
    state, stats = fn(state, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(EYE),
                      jnp.asarray(False), jnp.float32(1.0), jnp.float32(0.0))
    return state, np.asarray(stats)


def _torch_call(fn, state, rgb, depth, tick):
    state = state.replace(tick=torch.tensor(tick))
    state, stats = fn(state, torch.from_numpy(rgb), torch.from_numpy(depth),
                      torch.from_numpy(EYE), False, 1.0, 0.0)
    return state, stats.numpy()


@pytest.fixture(scope="module")
def runs():
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    i = seq.camera.intrinsics
    jfn = jstep.make_step(JIntr(i.fx, i.fy, i.cx, i.cy), H, W, JCfg(**CFG))
    tfn = tstep.make_step(TIntr(i.fx, i.fy, i.cx, i.cy), H, W, TCfg(**CFG))
    init = {k: np.asarray(v) for k, v in jstep.init_state(1 << 16, H, W)._asdict().items()}
    init["pose"] = seq.gt_pose(0).astype(np.float32)
    frames = [seq.frame(f) for f in range(N_FRAMES + 1)]
    js, ts = _jax_state(init), tstep.state_from_numpy(init, "cpu")
    jstats, tstats = [], []
    shared = None
    for f in range(N_FRAMES):
        js, s = _jax_call(jfn, js, *frames[f], f)
        jstats.append(s)
        ts, s = _torch_call(tfn, ts, *frames[f], f)
        tstats.append(s)
        if f == SHARED:
            shared = {k: np.array(v) for k, v in js._asdict().items()}
    return dict(jfn=jfn, tfn=tfn, frames=frames, shared=shared,
                jstats=np.stack(jstats), tstats=np.stack(tstats))


def test_state_numpy_round_trip(runs):
    """`state_from_numpy` / `state_to_numpy` carry every field of the
    reference's `SlamState`, in its dtypes, unchanged."""
    d = runs["shared"]
    assert set(d) == set(tstep.STATE_FIELDS)
    back = tstep.state_to_numpy(tstep.state_from_numpy(d, "cpu"))
    for k, v in d.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_one_step_from_shared_state(runs):
    """Both packages step frame SHARED+1 from the reference's state after
    frame SHARED.  Flags and counts exact; all 29 stats floats within rtol
    1e-3 (atol 1e-5 for entries near zero: pose rotation terms, errors); the
    updated map rows within 1e-4."""
    d = runs["shared"]
    f = SHARED + 1
    js, jst = _jax_call(runs["jfn"], _jax_state(d), *runs["frames"][f], f)
    ts, tst = _torch_call(runs["tfn"], tstep.state_from_numpy(d, "cpu"), *runs["frames"][f], f)
    exact = [tstep.STAT_TRACK_OK, tstep.STAT_FUSED, tstep.STAT_MATCHED, tstep.STAT_ADDED,
             tstep.STAT_CULLED, tstep.STAT_SURFELS, tstep.STAT_KEYFRAMES, tstep.STAT_DROPPED]
    np.testing.assert_array_equal(tst[exact], jst[exact])
    np.testing.assert_allclose(tst, jst, rtol=1e-3, atol=1e-5)
    out = tstep.state_to_numpy(ts)
    n = int(out["map_count"])
    assert n == int(js.map_count)
    np.testing.assert_allclose(out["map_data"][:n], np.asarray(js.map_data)[:n], atol=1e-4)
    for k in ("kf_count", "model_age"):
        assert int(out[k]) == int(getattr(js, k)), k
    for k in ("pose", "model_pose", "model_rel", "pred_depth", "pred_vmap"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(js, k)), atol=1e-4, err_msg=k)


def test_ten_frame_run_matches_reference(runs):
    """Independent 10-frame runs from one initial state: per-frame poses
    within 0.5 mm and 1e-3 rad, surfel counts within 1%, the same fuse
    decisions."""
    jst, tst = runs["jstats"], runs["tstats"]
    assert (tst[:, tstep.STAT_TRACK_OK] == 1).all()
    np.testing.assert_array_equal(tst[:, tstep.STAT_FUSED], jst[:, tstep.STAT_FUSED])
    for a, b in zip(tst[:, tstep.STAT_POSE0:], jst[:, tstep.STAT_POSE0:]):
        dT = np.linalg.inv(b.reshape(4, 4)) @ a.reshape(4, 4)
        assert np.linalg.norm(dT[:3, 3]) < 5e-4
        assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-3
    np.testing.assert_allclose(tst[:, tstep.STAT_SURFELS], jst[:, tstep.STAT_SURFELS], rtol=0.01)


@pytest.fixture(scope="module")
def reloc_fns():
    cfg = {**CFG, "relocalisation": True}
    i = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3).camera.intrinsics
    return (jstep.make_step(JIntr(i.fx, i.fy, i.cx, i.cy), H, W, JCfg(**cfg)),
            tstep.make_step(TIntr(i.fx, i.fy, i.cx, i.cy), H, W, TCfg(**cfg)))


@pytest.mark.parametrize(
    "consec_bad,model_age",
    [(5, 0), (10, jstep.MODEL_INVALID_AGE)],
    ids=["tracked-resets-counter", "invalid-model-trips-lost"],
)
def test_relocalisation_step_from_shared_state(runs, reloc_fns, consec_bad, model_age):
    """The step's relocalisation branch from the shared state: a tracked
    frame resets the device-side bad-frame counter; with the stored model
    invalid the frame is bad, the counter passes 10 (lost) and fusion is
    gated off.  Flags, counts and the counter exact; all stats within the
    one-step tolerance above."""
    jfn, tfn = reloc_fns
    d = {**runs["shared"], "consec_bad": np.int32(consec_bad), "model_age": np.int32(model_age)}
    f = SHARED + 1
    _, jst = _jax_call(jfn, _jax_state(d), *runs["frames"][f], f)
    _, tst = _torch_call(tfn, tstep.state_from_numpy(d, "cpu"), *runs["frames"][f], f)
    exact = [tstep.STAT_TRACK_OK, tstep.STAT_FUSED, tstep.STAT_ADDED, tstep.STAT_SURFELS,
             tstep.STAT_KEYFRAMES, tstep.STAT_CONSEC_BAD]
    np.testing.assert_array_equal(tst[exact], jst[exact])
    np.testing.assert_allclose(tst, jst, rtol=1e-3, atol=1e-5)
    expect_bad = consec_bad + 1 if model_age else 0
    assert tst[tstep.STAT_CONSEC_BAD] == expect_bad
    if model_age:
        assert tst[tstep.STAT_FUSED] == 0
