"""Parity of the port's fern keyframe database (`mapping/ferns.py` and the
fern half of `loops.py`) with the JAX package on the synthetic orbit: the
codes are bit-exact, and so are every insertion, eviction, growth and
retrieval decision."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import loops as jloops
from densemonoslam_tpu.config import EngineConfig as JCfg
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.mapping import ferns as jf
from densemonoslam_tpu_torch import loops as tloops
from densemonoslam_tpu_torch.config import EngineConfig as TCfg
from densemonoslam_tpu_torch.mapping import ferns as tf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def small(seq):
    """Per frame: (rgb8, depth8, intensity8) downsampled 8x, as numpy."""
    out = []
    for i in range(40):
        rgb, depth = seq.frame(i)
        r8 = rgb[::8, ::8].astype(np.float32)
        out.append((r8, depth[::8, ::8], 0.299 * r8[..., 0] + 0.587 * r8[..., 1] + 0.114 * r8[..., 2]))
    return out


def _coders(seq, seed=0, num_ferns=500):
    res = seq.camera.resolution
    args = (res.width // 8, res.height // 8, 8.0)
    return (jf.make_coder(*args, seed=seed, num_ferns=num_ferns),
            tf.make_coder(*args, seed=seed, num_ferns=num_ferns, device="cpu"))


def _db_equal(tdb, jdb):
    for name, t, j in zip(tf.FernDB._fields, tdb, jdb):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("seed,num_ferns", [(0, 500), (7, 64)])
def test_coder_and_codes_bit_exact(seq, small, seed, num_ferns):
    jc, tc = _coders(seq, seed, num_ferns)
    for name, t, j in zip(tf.FernCoder._fields, tc, jc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    for r8, d8, _ in small[::3]:
        np.testing.assert_array_equal(
            tf.encode(tc, torch.from_numpy(r8), torch.from_numpy(d8)).numpy(),
            np.asarray(jf.encode(jc, jnp.asarray(r8), jnp.asarray(d8))),
        )


@pytest.mark.parametrize("evict,thresh", [(False, jf.FERN_THRESH), (False, 0.05), (True, 0.05)],
                         ids=["novelty-gate", "fills-up", "evicts"])
def test_add_frame_sequence_matches_reference(seq, small, evict, thresh):
    """20 views through an 8-slot DB: the same dissimilarities (bit for bit),
    insertions, evictions and final DB."""
    jc, tc = _coders(seq)
    h, w = small[0][1].shape
    jdb, tdb = jf.empty_db(8, h, w), tf.empty_db(8, h, w, device="cpu")
    for i in range(0, 40, 2):
        r8, d8, i8 = small[i]
        jcode = jf.encode(jc, jnp.asarray(r8), jnp.asarray(d8))
        tcode = tf.encode(tc, torch.from_numpy(r8), torch.from_numpy(d8))
        np.testing.assert_array_equal(tf.dissimilarity(tdb, tcode).numpy(),
                                      np.asarray(jf.dissimilarity(jdb, jcode)))
        _, jdis = jf.best_match(jdb, jcode)
        _, tdis = tf.best_match(tdb, tcode)
        pose = seq.gt_pose(i).astype(np.float32)
        jdb, jadd = jf.add_frame(jdb, jcode, jnp.asarray(pose), jnp.asarray(i8), jnp.asarray(d8),
                                 time=i, min_dissim=jdis, thresh=thresh, evict=evict)
        tdb, tadd = tf.add_frame(tdb, tcode, torch.from_numpy(pose), torch.from_numpy(i8),
                                 torch.from_numpy(d8), time=i, min_dissim=tdis, thresh=thresh,
                                 evict=evict)
        assert bool(tadd) == bool(jadd), i
    _db_equal(tdb, jdb)


def test_retrieval_exclusion_and_photometric_check(seq, small):
    jc, tc = _coders(seq)
    h, w = small[0][1].shape
    jdb, tdb = jf.empty_db(16, h, w), tf.empty_db(16, h, w, device="cpu")
    for i in (0, 8, 16, 24, 32):
        r8, d8, i8 = small[i]
        pose = seq.gt_pose(i).astype(np.float32)
        jdb, _ = jf.add_frame(jdb, jf.encode(jc, jnp.asarray(r8), jnp.asarray(d8)), jnp.asarray(pose),
                              jnp.asarray(i8), jnp.asarray(d8), time=i, min_dissim=jnp.asarray(1.0))
        tdb, _ = tf.add_frame(tdb, tf.encode(tc, torch.from_numpy(r8), torch.from_numpy(d8)),
                              torch.from_numpy(pose), torch.from_numpy(i8), torch.from_numpy(d8),
                              time=i, min_dissim=torch.tensor(1.0))
    for q in (9, 23, 39):
        r8, d8, i8 = small[q]
        jcode = jf.encode(jc, jnp.asarray(r8), jnp.asarray(d8))
        tcode = tf.encode(tc, torch.from_numpy(r8), torch.from_numpy(d8))
        for excl in (float("inf"), 16.0, 0.0):
            ji, jd = jf.best_match(jdb, jcode, exclude_after=excl)
            ti, td = tf.best_match(tdb, tcode, exclude_after=excl)
            assert (int(ti), float(td)) == (int(ji), float(jd)), (q, excl)
        ti = int(tf.best_match(tdb, tcode)[0])
        np.testing.assert_allclose(
            float(tf.photometric_check(tdb.intensity[ti], torch.from_numpy(i8), tdb.depth[ti],
                                       torch.from_numpy(d8))),
            float(jf.photometric_check(jdb.intensity[ti], jnp.asarray(i8), jdb.depth[ti],
                                       jnp.asarray(d8))),
            rtol=1e-5,  # a masked mean over ~300 pixels, summed in another order
        )


def test_update_ferns_grows_then_evicts_like_reference(seq):
    """`loops.update_ferns` from a 4-slot DB with an 8-slot ceiling: the DB
    doubles once, then evicts; every state matches the reference's, and
    `fern_state_from_numpy` carries a reference state over unchanged."""
    jcfg, tcfg = JCfg(depth_cutoff=8.0, fern_thresh=0.05), TCfg(depth_cutoff=8.0, fern_thresh=0.05)
    jfs = jloops.make_fern_state(seq.camera, jcfg, capacity=4)
    tfs = tloops.make_fern_state(seq.camera, tcfg, capacity=4, device="cpu")
    for i in range(0, 40, 3):
        rgb, depth = seq.frame(i)
        inten = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
        pose = seq.gt_pose(i).astype(np.float32)
        jfs, jcode, jidx, jdis = jloops.update_ferns(
            jfs, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(inten), jnp.asarray(pose), i, 0.05,
            factor=8, max_capacity=8,
        )
        tfs, tcode, tidx, tdis = tloops.update_ferns(
            tfs, torch.from_numpy(rgb), torch.from_numpy(depth), torch.from_numpy(inten),
            torch.from_numpy(pose), i, 0.05, factor=8, max_capacity=8,
        )
        np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
        assert (int(tidx), float(tdis)) == (int(jidx), float(jdis)), i
    assert tfs.db.codes.shape[0] == 8 and int(tfs.db.count) == 8
    _db_equal(tfs.db, jfs.db)
    d = {**{k: np.asarray(v) for k, v in jfs.coder._asdict().items()},
         **{k: np.asarray(v) for k, v in jfs.db._asdict().items()}}
    back = tloops.fern_state_from_numpy(d, "cpu")
    _db_equal(back.db, jfs.db)
    for name, t, j in zip(tf.FernCoder._fields, back.coder, jfs.coder):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_fern_recovery_pose_matches_reference(seq):
    """`loops.fern_recovery_pose` reads a stored keyframe pose back to the
    host, so it is exact: one fern database, filled by both packages from
    the same frames, read at every slot."""
    jcfg, tcfg = JCfg(depth_cutoff=8.0, fern_thresh=0.05), TCfg(depth_cutoff=8.0, fern_thresh=0.05)
    jfs = jloops.make_fern_state(seq.camera, jcfg, capacity=8)
    tfs = tloops.make_fern_state(seq.camera, tcfg, capacity=8, device="cpu")
    for i in range(0, 40, 7):
        rgb, depth = seq.frame(i)
        inten = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
        pose = seq.gt_pose(i).astype(np.float32)
        jfs = jloops.update_ferns(jfs, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(inten),
                                  jnp.asarray(pose), i, 0.05, factor=8)[0]
        tfs = tloops.update_ferns(tfs, torch.from_numpy(rgb), torch.from_numpy(depth),
                                  torch.from_numpy(inten), torch.from_numpy(pose), i, 0.05,
                                  factor=8)[0]
    n = int(tfs.db.count)
    assert n == int(jfs.db.count) >= 3
    for idx in range(n):
        t, j = tloops.fern_recovery_pose(tfs, idx), jloops.fern_recovery_pose(jfs, idx)
        assert isinstance(t, np.ndarray) and t.shape == (4, 4)
        np.testing.assert_array_equal(t, j, err_msg=str(idx))
    np.testing.assert_array_equal(tloops.fern_recovery_pose(tfs, n - 1), seq.gt_pose(35).astype(
        np.float32))
