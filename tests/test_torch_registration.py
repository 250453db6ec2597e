"""Wide-baseline registration and `Engine.batch_align` on the PyTorch port
(CPU): the graduated-non-convexity solve and the whole registration held
against the JAX package's `tracking.registration` on the same inputs, and
`tests/test_engine.py::test_batch_align_merges_maps`'s scenario held to its
bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.tracking import registration as jreg
from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.ops import preprocess
from densemonoslam_tpu_torch.tracking import registration as treg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


def _rigid(rng):
    w = rng.normal(0, 0.3, 3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    T[:3, 3] = rng.normal(0, 0.3, 3)
    return T


def test_gnc_rigid_align_matches_reference():
    """200 correspondences, a quarter of them outliers: the same R and t
    (the SVD's singular-vector signs may differ; R may not), inlier count
    and rms."""
    rng = np.random.default_rng(0)
    T_true = _rigid(rng)
    P = (rng.uniform(-1, 1, (200, 3)) + [0, 0, 2]).astype(np.float32)
    Q = (P @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    Q[:50] += rng.normal(0, 0.5, (50, 3)).astype(np.float32)
    Q[50:] += rng.normal(0, 0.002, (150, 3)).astype(np.float32)
    valid = rng.random(200) < 0.95
    jT, jn, jrms = jreg.gnc_rigid_align(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(valid))
    tT, tn, trms = treg.gnc_rigid_align(torch.from_numpy(P), torch.from_numpy(Q), torch.from_numpy(valid))
    np.testing.assert_allclose(tT[:3, :3].numpy(), np.asarray(jT)[:3, :3], atol=1e-5)
    np.testing.assert_allclose(tT[:3, 3].numpy(), np.asarray(jT)[:3, 3], atol=1e-5)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(trms), float(jrms), rtol=1e-4)
    np.testing.assert_allclose(tT.numpy(), T_true, atol=5e-3)


def test_global_registration_matches_reference(seq):
    """Two views 3 frames apart: the port's transform within 1 mm / 1e-4 of
    the JAX package's and its inliers within 2; then each view with its own
    intrinsics."""
    rgb_a, d_a = seq.frame(0)
    rgb_b, d_b = seq.frame(3)
    intr = seq.camera.intrinsics
    ia = preprocess.rgb_to_intensity(torch.from_numpy(rgb_a))
    ib = preprocess.rgb_to_intensity(torch.from_numpy(rgb_b))
    tT, tn, trms = treg.global_registration(
        ia, torch.from_numpy(d_a), ib, torch.from_numpy(d_b), intr, intr
    )
    jT, jn, jrms = jreg.global_registration(
        jnp.asarray(ia.numpy()), jnp.asarray(d_a), jnp.asarray(ib.numpy()), jnp.asarray(d_b), intr
    )
    np.testing.assert_allclose(tT[:3, :3].numpy(), np.asarray(jT)[:3, :3], atol=1e-4)
    np.testing.assert_allclose(tT[:3, 3].numpy(), np.asarray(jT)[:3, 3], atol=1e-3)
    assert abs(tn - jn) <= 2 and tn >= 30
    true = np.linalg.inv(seq.gt_pose(3)) @ seq.gt_pose(0)
    assert np.linalg.norm(tT[:3, 3].numpy() - true[:3, 3]) < 0.02
    # per-frame intrinsics (ROADMAP R4): view b cropped by 8 columns and 6
    # rows is a camera whose principal point moved; backprojected with its
    # own intrinsics it aligns as well, with view a's it does not
    ib2, db2 = ib[6:, 8:].contiguous(), torch.from_numpy(d_b)[6:, 8:].contiguous()
    crop = CameraIntrinsics(intr.fx, intr.fy, intr.cx - 8, intr.cy - 6)
    T2, n2, _ = treg.global_registration(ia, torch.from_numpy(d_a), ib2, db2, intr, crop)
    T1, _, _ = treg.global_registration(ia, torch.from_numpy(d_a), ib2, db2, intr, intr)
    err2 = np.linalg.norm(T2[:3, 3].numpy() - true[:3, 3])
    err1 = np.linalg.norm(T1[:3, 3].numpy() - true[:3, 3])
    assert n2 >= 30 and err2 < 0.02 and err1 > 2 * err2, (err2, err1)


def test_batch_align_merges_maps(seq):
    """`tests/test_engine.py::test_batch_align_merges_maps`'s scenario and
    bounds: two cameras in separate maps align without an initial guess
    (inliers >= 30, rms < 0.25, translation within 0.2 m) and merge."""
    eng = Engine(seq.camera, EngineConfig(max_surfels=1 << 17, depth_cutoff=8.0, depth_factor=1.0),
                 device="cpu")
    eng.frontend("camA")
    eng.frontend("camB")
    for i in range(3):
        eng.process_frame("camA", *seq.frame(i), float(i))
    for i in range(3, 6):
        eng.process_frame("camB", *seq.frame(i), float(i))
    assert eng.frontends["camA"].map_name != eng.frontends["camB"].map_name
    out = eng.batch_align("camA", "camB", merge=True)
    assert out is not None, "batch align rejected a genuine overlap"
    T_ab, inliers, rms = out
    assert inliers >= 30 and rms < 0.25
    T_true = np.linalg.inv(seq.gt_pose(3)) @ seq.gt_pose(0)
    assert np.linalg.norm(T_ab[:3, 3] - T_true[:3, 3]) < 0.2
    assert eng.frontends["camA"].map_name == eng.frontends["camB"].map_name
