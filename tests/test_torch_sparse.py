"""The port's sparse ORB-style tracker (`densemonoslam_tpu_torch.tracking.
sparse`) against the JAX package's on the same numpy frames of the synthetic
orbit at 160x120."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.tracking import sparse as js
from densemonoslam_tpu_torch.tracking import sparse as ts

torch.set_num_threads(2)


def _intensity(rgb):
    r = rgb.astype(np.float32)
    return (0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]).astype(np.float32)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return [(_intensity(rgb), depth) for rgb, depth in (seq.frame(i) for i in range(6))]


def _tkp(kp):
    """A JAX keypoint set as the port's (uint32 words as int64)."""
    f = {k: np.array(getattr(kp, k)) for k in js.Keypoints._fields}
    f["desc"] = f["desc"].astype(np.int64)
    return ts.Keypoints(**{k: torch.from_numpy(v) for k, v in f.items()})


@pytest.mark.parametrize("i", [0, 5])
def test_detect_and_describe_matches_reference(frames, i):
    """Octave 0: the same keypoint slots (uv, depth and validity in every
    slot, the slots past the last corner included), bit-equal scores and
    descriptors of the valid keypoints, angles within 1e-4 rad."""
    inten, depth = frames[i]
    kj = js.detect_and_describe(jnp.asarray(inten), jnp.asarray(depth))
    kt = ts.detect_and_describe(torch.from_numpy(inten), torch.from_numpy(depth))
    v = np.asarray(kj.valid)
    assert v.sum() > 300
    np.testing.assert_array_equal(kt.valid.numpy(), v)
    np.testing.assert_array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(kt.depth.numpy(), np.asarray(kj.depth))
    np.testing.assert_array_equal(kt.score.numpy()[v], np.asarray(kj.score)[v])
    np.testing.assert_allclose(kt.angle.numpy()[v], np.asarray(kj.angle)[v], atol=1e-4)
    np.testing.assert_array_equal(kt.desc.numpy()[v].astype(np.uint32), np.asarray(kj.desc)[v])


def test_detect_pyramid_overlaps_reference(frames):
    """Octaves >= 1 see an antialiased resize that differs from
    `jax.image.resize` by float rounding, which may flip a FAST test: per
    octave, the valid keypoint sets overlap >= 95% (intersection over
    union); octave 0 is identical."""
    inten, depth = frames[3]
    kj = js.detect_pyramid(jnp.asarray(inten), jnp.asarray(depth))
    kt = ts.detect_pyramid(torch.from_numpy(inten), torch.from_numpy(depth))
    o = 0
    for q in js._octave_quotas(js.OCTAVES, js.SCALE_FACTOR, js.MAX_KEYPOINTS):
        sl = slice(o, o + q)
        a = {tuple(p) for p, ok in zip(np.asarray(kj.uv)[sl], np.asarray(kj.valid)[sl]) if ok}
        b = {tuple(p) for p, ok in zip(kt.uv.numpy()[sl], kt.valid.numpy()[sl]) if ok}
        assert len(a) > 30
        assert len(a & b) >= 0.95 * len(a | b), (o, len(a), len(b), len(a & b))
        if o == 0:
            assert a == b
        o += q


def test_match_pose_and_retrieval_match_reference(frames):
    """On the same keypoint sets (the JAX package's): identical matches and
    distances, motion-only pose within 1e-4, the same inlier count and mean
    error within 1e-3 px; bit summaries equal and retrieval picks the same
    candidates."""
    kps = [js.detect_pyramid(jnp.asarray(i), jnp.asarray(d)) for i, d in frames[:6:2]]
    a, b = kps[0], kps[1]
    mj, dj = js.match(a, b)
    mt, dt = ts.match(_tkp(a), _tkp(b))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (np.asarray(mj) >= 0).sum() > 50
    intr_j = SyntheticSequence(num_frames=2).camera.intrinsics
    from densemonoslam_tpu_torch.config import CameraIntrinsics
    intr_t = CameraIntrinsics(intr_j.fx, intr_j.fy, intr_j.cx, intr_j.cy)
    Aj, inl_j, err_j = js.motion_only_pose(a, b, mj, intr_j, jnp.eye(4, dtype=jnp.float32))
    At, inl_t, err_t = ts.motion_only_pose(_tkp(a), _tkp(b), mt, intr_t, torch.eye(4))
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), atol=1e-4)
    assert float(inl_t) == float(inl_j) and float(inl_j) > 30
    np.testing.assert_allclose(float(err_t), float(err_j), atol=1e-3)

    sj = np.stack([np.asarray(js.desc_summary(k)) for k in kps])
    st = torch.stack([ts.desc_summary(_tkp(k)) for k in kps])
    np.testing.assert_array_equal(st.numpy(), sj)
    summ = np.zeros((8, 256), np.float32)
    summ[:3] = sj
    summ[3] = sj[0]  # a tie with row 0: the lower index must come first
    ij, simj = js.retrieve(jnp.asarray(summ), jnp.asarray(4), jnp.asarray(sj[0]), jnp.asarray(4))
    it, simt = ts.retrieve(torch.from_numpy(summ), 4, torch.from_numpy(sj[0]), 4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(simt.numpy(), np.asarray(simj), atol=1e-6)


def test_sparse_tracker_matches_reference(seq):
    """`SparseTracker` over frames 0-13 of the orbit and then 0-7 again (a
    jump back that the motion-only tracker cannot follow, then a revisit),
    with keyframes every ~3 cm, local BA on every window and loop checks
    10 ticks back: the same ok flags, every returned pose within 2e-3 (m,
    and in the rotation entries) of the JAX tracker's, the same keyframe
    ticks, the same number of local BA runs and of loop closures (each
    followed by a pose-graph optimisation)."""
    from densemonoslam_tpu_torch.config import CameraIntrinsics

    kw = dict(keyframe_min_disp=0.03, local_ba_min_baseline=0.0, loop_min_gap=10,
              loop_min_votes=40)
    ij = seq.camera.intrinsics
    tj = js.SparseTracker(ij, **kw)
    tt = ts.SparseTracker(CameraIntrinsics(ij.fx, ij.fy, ij.cx, ij.cy), device="cpu", **kw)
    tj.pose = tt.pose = seq.gt_pose(0).astype(np.float32)
    for i in list(range(14)) + list(range(8)):
        rgb, depth = seq.frame(i)
        inten = _intensity(rgb)
        pj, okj = tj.track(jnp.asarray(inten), jnp.asarray(depth))
        pt, okt = tt.track(torch.from_numpy(inten), torch.from_numpy(depth))
        assert bool(okt) == bool(okj)
        np.testing.assert_allclose(pt.numpy()[:3, 3], np.asarray(pj)[:3, 3], atol=2e-3)
        np.testing.assert_allclose(pt.numpy()[:3, :3], np.asarray(pj)[:3, :3], atol=2e-3)
    tj.flush()
    tt.flush()
    assert [t for _, _, t in tt.keyframes] == [t for _, _, t in tj.keyframes]
    for (_, p_t, _), (_, p_j, _) in zip(tt.keyframes, tj.keyframes):
        np.testing.assert_allclose(p_t, np.asarray(p_j), atol=2e-3)
    np.testing.assert_allclose(tt.pose, np.asarray(tj.pose), atol=2e-3)
    assert tt.local_ba_runs == tj.local_ba_runs >= 1
    assert tt.loops_closed == tj.loops_closed >= 1
