"""Parity of the PyTorch port's tracking stack (reductions + odometry) with
the JAX package: the same frames, model maps and warm start go to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.ops import reductions as jred
from densemonoslam_tpu.tracking import odometry as jodo
from densemonoslam_tpu.utils import se3 as jse3
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.ops import reductions as tred
from densemonoslam_tpu_torch.tracking import odometry as todo

torch.set_num_threads(2)

LEVELS = 3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    """Frame 6 tracked against frame 5's pyramid as the model (the engine
    tests' orbit), with a warm start 1 cm / ~0.6 deg off the true motion."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    i = seq.camera.intrinsics
    ji, ti = JIntr(i.fx, i.fy, i.cx, i.cy), TIntr(i.fx, i.fy, i.cx, i.cy)
    (rgb_m, d_m), (rgb_c, d_c) = seq.frame(5), seq.frame(6)
    rel = np.linalg.inv(seq.gt_pose(5)) @ seq.gt_pose(6)
    A0 = (np.asarray(jse3.se3_exp(jnp.asarray([0.01, 0.0, -0.005, 0.01, -0.005, 0.0],
                                              jnp.float32))) @ rel).astype(np.float32)
    jm = jodo.model_pyramid_from_frame(jodo.build_frame_pyramid(
        jnp.asarray(rgb_m), jnp.asarray(d_m), ji, LEVELS))
    jf = jodo.build_frame_pyramid(jnp.asarray(rgb_c), jnp.asarray(d_c), ji, LEVELS)
    # the port's own pyramids, checked against the reference's below; the
    # row and track tests then feed BOTH packages the reference's maps
    own_m = todo.build_frame_pyramid(_t(rgb_m), _t(d_m), ti, LEVELS)
    own_f = todo.build_frame_pyramid(_t(rgb_c), _t(d_c), ti, LEVELS)
    tm = todo.ModelPyramid(pack=tuple(_t(p) for p in jm.pack))
    tf = todo.FramePyramid(*(tuple(_t(x) for x in field) for field in jf))
    return dict(ji=ji, ti=ti, jm=jm, jf=jf, tm=tm, tf=tf, own_m=own_m, own_f=own_f,
                A0=A0, rel=rel.astype(np.float32))


def test_frame_and_model_pyramids_match(setup):
    """The port's pyramids within 1e-5 m (vertices) and 1e-4 (pixel-unit
    images) of the reference's."""
    for name in ("vmap", "nmap", "intensity", "grad_x", "grad_y"):
        for a, b in zip(getattr(setup["own_f"], name), getattr(setup["jf"], name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    own = setup["own_m"]
    packs = todo.model_pyramid_from_maps(own.intensity, own.vmap, own.nmap, own.grad_x,
                                         own.grad_y).pack
    for a, b in zip(packs, setup["jm"].pack):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bilinear", [True, False])
def test_joint_rows_packed_and_frozen_match(setup, bilinear):
    """Row matrices built from the same inputs: gates agree on >= 99.9% of
    rows (a residual sitting on a gate threshold may flip by one ulp), and
    where both kept a row its values agree within rtol 1e-4 / atol 1e-3
    (Jacobian entries reach ~1e4 in intensity-per-metre units)."""
    lv = 1
    ji, ti = setup["ji"].scaled(lv), setup["ti"].scaled(lv)
    fj, ft, mj, mt = setup["jf"], setup["tf"], setup["jm"], setup["tm"]
    A = setup["A0"]
    Mj = jred.joint_rows_packed(fj.vmap[lv], fj.nmap[lv], fj.intensity[lv], mj.pack[lv],
                                jnp.asarray(A), ji, bilinear=bilinear)
    Mt = tred.joint_rows_packed(ft.vmap[lv], ft.nmap[lv], ft.intensity[lv], mt.pack[lv],
                                _t(A), ti, bilinear=bilinear)
    # frozen rows: sample at A, evaluate at a nearby A
    P = ft.intensity[lv].numel()
    A1 = (np.asarray(jse3.se3_exp(jnp.asarray([0.002, -0.001, 0.0, 0.003, 0.0, 0.001],
                                              jnp.float32))) @ A).astype(np.float32)
    vj, nj, ij = (fj.vmap[lv].reshape(P, 3), fj.nmap[lv].reshape(P, 3), fj.intensity[lv].reshape(P))
    vt, nt, it = (ft.vmap[lv].reshape(P, 3), ft.nmap[lv].reshape(P, 3), ft.intensity[lv].reshape(P))
    from densemonoslam_tpu.ops import geometry as jgeo
    from densemonoslam_tpu_torch.ops import geometry as tgeo

    uj, vvj, _ = jgeo.project(jse3.transform_points(jnp.asarray(A), vj), ji)
    ut, vvt, _ = tgeo.project(tred.se3.transform_points(_t(A), vt), ti)
    sj = jred.sample_model(mj.pack[lv], uj, vvj, bilinear=bilinear)
    st = tred.sample_model(mt.pack[lv], ut, vvt, bilinear=bilinear)
    Fj = jred.joint_rows_frozen(vj, nj, ij, sj, jnp.stack([uj, vvj], -1), jnp.asarray(A1), ji)
    Ft = tred.joint_rows_frozen(vt, nt, it, st, torch.stack([ut, vvt], -1), _t(A1), ti)
    for t_rows, j_rows in zip(Mt + Ft, Mj + Fj):
        t_rows, j_rows = t_rows.numpy(), np.asarray(j_rows)
        keep_t, keep_j = t_rows[:, 7] > 0, j_rows[:, 7] > 0
        assert keep_t.sum() > 100
        assert (keep_t == keep_j).mean() >= 0.999
        both = keep_t & keep_j
        np.testing.assert_allclose(t_rows[both], j_rows[both], rtol=1e-4, atol=1e-3)


def test_combined_system_and_solves_match(rng):
    """Same rows in -> same normal equations and solves.  JtJ within the
    Gram tolerance (rtol 2e-5 / atol 1e-2 on sums of ~5000 products), the
    solved twist within 1e-4 relative (a 6x6 solve of that system)."""
    P = 5000
    Mi = rng.normal(0, 1, (P, 8)).astype(np.float32)
    Mr = rng.normal(0, 1, (P, 8)).astype(np.float32)
    Mi[:, 7] = Mr[:, 7] = 1.0
    gj = jred.combined_system(jnp.asarray(Mi), jnp.asarray(Mr), 10.0, 1.0 / 255.0**2)
    gt = tred.combined_system(_t(Mi), _t(Mr), 10.0, 1.0 / 255.0**2)
    for a, b in zip(gt[2:], gj[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-2)
    JtJ = np.asarray(gj[2])
    Jtr = np.asarray(gj[3])
    xj = jred.solve_se3(jnp.asarray(JtJ), jnp.asarray(Jtr), 1e-8)
    xt = tred.solve_se3(_t(JtJ), _t(Jtr), 1e-8)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tred.solve_so3(_t(JtJ[:3, :3]), _t(Jtr[:3]), 1e-4).numpy(),
                               np.asarray(jred.solve_so3(jnp.asarray(JtJ[:3, :3]),
                                                         jnp.asarray(Jtr[:3]), 1e-4)),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tred.diag_inv_6x6(_t(JtJ)).numpy(),
                               np.asarray(jred.diag_inv_6x6(jnp.asarray(JtJ))),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("row_stride", [1, 2])
def test_track_matches_reference(setup, row_stride):
    """Full SO3 + coarse-to-fine GN: the returned relative pose agrees within
    1e-4 m and 1e-4 rad, and both land within 2 mm of the true motion."""
    kw = dict(iterations=(4, 5, 10), icp_weight=10.0, row_stride=row_stride)
    rj = jodo.track(setup["jm"], setup["jf"], jnp.asarray(setup["A0"]), setup["ji"], **kw)
    rt = todo.track(setup["tm"], setup["tf"], _t(setup["A0"]), setup["ti"], **kw)
    Aj, At = np.asarray(rj.A), rt.A.numpy()
    assert not bool(rt.failed) and not bool(rj.failed)
    dT = np.linalg.inv(Aj) @ At
    assert np.linalg.norm(dT[:3, 3]) < 1e-4
    assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-4
    assert abs(float(rt.icp_inliers) - float(rj.icp_inliers)) <= 0.001 * float(rj.icp_inliers)
    assert np.linalg.norm(At[:3, 3] - setup["rel"][:3, 3]) < 2e-3


def test_frame_pyramid_from_maps_and_covariance_match(setup):
    """A rendered-style prediction (frame 5's level-0 maps) as the live frame
    of model-to-model tracking: the pyramid within the tolerances above, the
    pose within 1e-4 and the covariance diagonal within rtol 1e-3 (the
    inverse of a 6x6 JtJ summed in another order).  Tracked with the
    arguments of the test above, so the JAX package's compiled `track` is
    reused; the local loop's `use_so3=False` call is held by
    `tests/test_torch_loops.py`."""
    jf0 = setup["jf"]
    jp = jodo.frame_pyramid_from_maps(jf0.intensity[0], jf0.vmap[0], jf0.nmap[0], LEVELS)
    tp = todo.frame_pyramid_from_maps(_t(jf0.intensity[0]), _t(jf0.vmap[0]), _t(jf0.nmap[0]),
                                      LEVELS)
    for name in ("vmap", "nmap", "intensity", "grad_x", "grad_y"):
        for a, b in zip(getattr(tp, name), getattr(jp, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    kw = dict(iterations=(4, 5, 10), icp_weight=10.0, row_stride=1)
    rj = jodo.track(setup["jm"], jp, jnp.asarray(setup["A0"]), setup["ji"], **kw)
    rt = todo.track(setup["tm"], tp, _t(setup["A0"]), setup["ti"], **kw)
    np.testing.assert_allclose(rt.A.numpy(), np.asarray(rj.A), atol=1e-4)
    np.testing.assert_allclose(np.diag(todo.covariance(rt).numpy()),
                               np.diag(np.asarray(jodo.covariance(rj))), rtol=1e-3)


def _own_pyramids(seq, i):
    """Frame i's pyramid built by each package from the same numpy frame."""
    rgb, d = seq.frame(i)
    c = seq.camera.intrinsics
    ji, ti = JIntr(c.fx, c.fy, c.cx, c.cy), TIntr(c.fx, c.fy, c.cx, c.cy)
    return (jodo.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(d), ji, LEVELS),
            todo.build_frame_pyramid(_t(rgb), _t(d), ti, LEVELS), ji, ti)


def test_frame_to_frame_pair_matches_reference():
    """Frame-to-frame tracking (`model_pyramid_from_frame`) of frames 0 -> 1
    of `tests/test_odometry.py`'s orbit from the identity, each package on
    its own pyramids: the relative poses agree within 1e-4 m and 1e-4 rad
    (the tolerance of `test_track_matches_reference`: two f32 GN runs)."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    jp0, tp0, ji, ti = _own_pyramids(seq, 0)
    jp1, tp1, _, _ = _own_pyramids(seq, 1)
    packs = todo.model_pyramid_from_frame(tp0).pack
    for a, b in zip(packs, jodo.model_pyramid_from_frame(jp0).pack):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    kw = dict(iterations=(4, 5, 10), icp_weight=10.0, row_stride=1)
    rj = jodo.track(jodo.model_pyramid_from_frame(jp0), jp1, jnp.eye(4, dtype=jnp.float32), ji,
                    **kw)
    rt = todo.track(todo.model_pyramid_from_frame(tp0), tp1, torch.eye(4), ti, **kw)
    assert not bool(rt.failed) and not bool(rj.failed)
    dT = np.linalg.inv(np.asarray(rj.A)) @ rt.A.numpy()
    assert np.linalg.norm(dT[:3, 3]) < 1e-4
    assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-4


def test_frame_to_frame_accumulated_run_matches_reference():
    """`tests/test_odometry.py::test_track_sequence_accumulated_drift` on the
    port: 19 frame-to-frame tracks chained from the true first pose, ATE
    under that test's 10 mm, and every chained pose within 0.5 mm of the
    JAX package's (19 f32 relative poses of ~1e-5 m disagreement each,
    compounded)."""
    from densemonoslam_tpu_torch.eval import ate_rmse

    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    kw = dict(iterations=(4, 5, 10), icp_weight=10.0, row_stride=1)
    pj, pt = [seq.gt_pose(0)], [seq.gt_pose(0)]
    prev_j, prev_t, ji, ti = _own_pyramids(seq, 0)
    for i in range(1, 20):
        cur_j, cur_t, _, _ = _own_pyramids(seq, i)
        rj = jodo.track(jodo.model_pyramid_from_frame(prev_j), cur_j,
                        jnp.eye(4, dtype=jnp.float32), ji, **kw)
        rt = todo.track(todo.model_pyramid_from_frame(prev_t), cur_t, torch.eye(4), ti, **kw)
        assert not bool(rt.failed), f"tracking failed at frame {i}"
        pj.append(pj[-1] @ np.asarray(rj.A))
        pt.append(pt[-1] @ rt.A.numpy())
        prev_j, prev_t = cur_j, cur_t
    err = ate_rmse(pt, [seq.gt_pose(i) for i in range(20)])
    assert err < 0.01, f"ATE {err:.4f} m"
    gaps = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(pt, pj)]
    assert max(gaps) < 5e-4, gaps


def test_track_on_the_cpu_takes_the_plain_path(setup, monkeypatch):
    """A CPU track runs the plain op-by-op composition: the fused iteration's
    wrapper is never called, and no K1 or fused-iteration launch is
    counted."""
    from densemonoslam_tpu_torch.ops import track_iter
    from densemonoslam_tpu_torch.utils import launches

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path called the fused iteration")

    monkeypatch.setattr(track_iter, "gn_iteration", refuse)
    monkeypatch.setattr(track_iter, "so3_iteration", refuse)
    before = launches.COUNTS.copy()
    for kw in (dict(iterations=(4, 5, 10), row_stride=2),
               dict(iterations=(50, 50, 50), use_so3=False), dict(iterations=(4, 5, 10),
                                                                  nearest_finest=False)):
        res = todo.track(setup["tm"], setup["tf"], _t(setup["A0"]), setup["ti"], **kw)
        assert not bool(res.failed)
    assert launches.COUNTS == before
