"""Parity of the PyTorch port's mapping modules (splat render, window fusion
+ insertion, compaction, NID gate) with the JAX package, on one surfel map
built in numpy from two synthetic frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.mapping import fusion as jfus
from densemonoslam_tpu.mapping import keyframe as jkf
from densemonoslam_tpu.mapping import surfel_map as jsm
from densemonoslam_tpu.ops import geometry as jgeo
from densemonoslam_tpu.ops import histogram as jhist
from densemonoslam_tpu.ops import splat as jsplat
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.mapping import fusion as tfus
from densemonoslam_tpu_torch.mapping import keyframe as tkf
from densemonoslam_tpu_torch.mapping import surfel_map as tsm
from densemonoslam_tpu_torch.ops import histogram as thist
from densemonoslam_tpu_torch.ops import splat as tsplat

torch.set_num_threads(2)

CAP = 1 << 16
H, W = 120, 160


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def world():
    """Surfels from frames 0 and 1 at their true poses: random confidences
    (some culled), last-seen ticks and radii in the reference layout."""
    rng = np.random.default_rng(7)
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    i = seq.camera.intrinsics
    ji, ti = JIntr(i.fx, i.fy, i.cx, i.cy), TIntr(i.fx, i.fy, i.cx, i.cy)
    rows = []
    for f in (0, 1):
        rgb, depth = seq.frame(f)
        T = seq.gt_pose(f).astype(np.float32)
        v = np.asarray(jgeo.backproject(jnp.asarray(depth), ji)).reshape(-1, 3)
        n = np.asarray(jgeo.normal_map(jgeo.backproject(jnp.asarray(depth), ji))).reshape(-1, 3)
        ok = (v[:, 2] > 0) & (np.linalg.norm(n, axis=1) > 0.5)
        r = np.zeros((ok.sum(), 16), np.float32)
        r[:, 0:3] = v[ok] @ T[:3, :3].T + T[:3, 3]
        r[:, 3] = rng.uniform(0.5, 20.0, ok.sum())
        r[:, 4:7] = rgb.reshape(-1, 3)[ok]
        r[:, 7] = 1.41421356 * v[ok, 2] / i.fx / np.maximum(np.abs(n[ok, 2]), 0.5)
        r[:, 8:11] = n[ok] @ T[:3, :3].T
        r[:, 11] = rng.integers(0, 10, ok.sum())
        r[:, 12] = r[:, 11] + rng.integers(0, 300, ok.sum())
        rows.append(r)
    rows = np.concatenate(rows)
    rows[rng.random(len(rows)) < 0.03, 3] = 0.0  # culled slots
    data = np.zeros((CAP + 1, 16), np.float32)
    data[: len(rows)] = rows
    rgb2, depth2 = seq.frame(2)
    return dict(data=data, count=len(rows), ji=ji, ti=ti, seq=seq,
                pose=seq.gt_pose(2).astype(np.float32), rgb=rgb2, depth=depth2)


def _render_both(w, **kw):
    jp = jsplat.render(jnp.asarray(w["data"]), jnp.asarray(w["count"], jnp.int32),
                       jnp.asarray(w["pose"]), w["ji"], W, H, 250, **kw)
    tp = tsplat.render(_t(w["data"]), torch.tensor(w["count"]), _t(w["pose"]), w["ti"],
                       W, H, 250, **kw)
    return jp, tp


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode=jsplat.MODE_ACTIVE, time_delta=200),
        dict(mode=jsplat.MODE_ACTIVE, time_delta=200, window=1 << 15),
        dict(mode=jsplat.MODE_ALL, packed_zbuffer=False),
        dict(mode=jsplat.MODE_INACTIVE, time_delta=200),
    ],
    ids=["active", "active-window", "all-exact", "inactive"],
)
def test_render_matches_reference(world, kw):
    """Surfel index equal on >= 99.5% of pixels (the packed key is bit-exact,
    so only f32 rounding of a projection on a pixel or disk edge can flip
    a winner); where equal, depth and vertices within 1e-4 m."""
    jp, tp = _render_both(world, **kw)
    ji, ti = np.asarray(jp.index), tp.index.numpy()
    assert (ji >= 0).sum() > 1000
    same = ji == ti
    assert same.mean() >= 0.995
    np.testing.assert_allclose(tp.depth.numpy()[same], np.asarray(jp.depth)[same], atol=1e-4)
    np.testing.assert_allclose(tp.vmap.numpy()[same], np.asarray(jp.vmap)[same], atol=1e-4)
    np.testing.assert_allclose(tp.nmap.numpy()[same], np.asarray(jp.nmap)[same], atol=1e-4)
    np.testing.assert_allclose(tp.color.numpy()[same], np.asarray(jp.color)[same], atol=1e-3)
    assert (np.asarray(jp.cell) == tp.cell.numpy()).mean() >= 0.995


def test_fuse_window_and_place_updates_match(world):
    """From the SAME prediction (the reference's render): integer outputs
    (ranks, counts, matched/culled) exact, fused rows within 1e-4."""
    w = world
    kw = dict(mode=jsplat.MODE_ACTIVE, time_delta=200, window=1 << 15)
    jp, _ = _render_both(w, **kw)
    tp = tsplat.Prediction(*(_t(x).long() if x.dtype == jnp.int32 else _t(x) for x in jp))
    n_win = 1 << 15
    start = int(np.clip(w["count"] - n_win, 0, CAP - n_win))
    vmap = np.asarray(jgeo.backproject(jnp.asarray(w["depth"]), w["ji"]))
    nmap = np.asarray(jgeo.normal_map(jnp.asarray(vmap)))
    args = dict(time=250, weight_mult=0.8, clean_depth=w["depth"], cluster_id=2.0)
    jout = jfus.fuse_window(
        jnp.asarray(w["data"][start:start + n_win]), jnp.asarray(start, jnp.int32),
        jnp.asarray(w["count"], jnp.int32), jp, jnp.asarray(vmap), jnp.asarray(nmap),
        jnp.asarray(w["rgb"], jnp.float32), jnp.asarray(w["pose"]), w["ji"],
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in args.items()},
    )
    tout = tfus.fuse_window(
        _t(w["data"][start:start + n_win]), torch.tensor(start), torch.tensor(w["count"]), tp,
        _t(vmap), _t(nmap), _t(w["rgb"]).float(), _t(w["pose"]), w["ti"],
        **{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in args.items()},
    )
    jblk, jpacked, jrank, jn, jmatched, jculled = (np.asarray(x) for x in jout)
    tblk, tpacked, trank, tn, tmatched, tculled = (x.numpy() for x in tout)
    assert int(jmatched) > 1000 and int(jn) > 100 and int(jculled) > 0
    assert (int(tmatched), int(tn), int(tculled)) == (int(jmatched), int(jn), int(jculled))
    assert (trank == jrank).all()
    np.testing.assert_allclose(tblk, jblk, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpacked, jpacked, rtol=1e-4, atol=1e-4)

    jd, jc, jadded, jdrop = jfus.place_updates(
        jnp.asarray(w["data"]), jnp.asarray(w["count"], jnp.int32), jnp.asarray(jblk),
        jnp.asarray(start, jnp.int32), jnp.asarray(jpacked), jnp.asarray(jn), jnp.asarray(jrank))
    td, tc, tadded, tdrop = tfus.place_updates(
        _t(w["data"]), torch.tensor(w["count"]), _t(jblk), torch.tensor(start), _t(jpacked),
        torch.tensor(int(jn)), _t(jrank).long())
    assert (int(tc), int(tadded), int(tdrop)) == (int(jc), int(jadded), int(jdrop))
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_place_updates_headroom_guard_drops_and_counts():
    """A nearly full map keeps one row of headroom and reports the rest as
    dropped, like the reference."""
    cap = 40
    data = np.zeros((cap + 1, 16), np.float32)
    packed = np.arange(30 * 16, dtype=np.float32).reshape(30, 16)
    rank = np.where(np.arange(30) % 2 == 0, np.arange(30) // 2, -1).astype(np.int32)
    blk = np.ones((8, 16), np.float32)
    jd, jc, jadd, jdrop = jfus.place_updates(
        jnp.asarray(data), jnp.asarray(32, jnp.int32), jnp.asarray(blk), jnp.asarray(24, jnp.int32),
        jnp.asarray(packed), jnp.asarray(15, jnp.int32), jnp.asarray(rank))
    td, tc, tadd, tdrop = tfus.place_updates(
        _t(data), torch.tensor(32), _t(blk), torch.tensor(24), _t(packed), torch.tensor(15),
        _t(rank).long())
    assert (int(tc), int(tadd), int(tdrop)) == (int(jc), int(jadd), int(jdrop)) == (39, 7, 8)
    assert np.array_equal(td.numpy()[:cap], np.asarray(jd)[:cap])


@pytest.mark.parametrize("max_active", [0, 1 << 14])
def test_compact_matches_reference(world, max_active):
    """Stable partition [inactive..., active...]: rows and count exact."""
    w = world
    jm = jsm.compact(jsm.SurfelMap(data=jnp.asarray(w["data"]),
                                   count=jnp.asarray(w["count"], jnp.int32)),
                     time=250.0, time_delta=200, max_active=max_active)
    tm = tsm.compact(tsm.SurfelMap(data=_t(w["data"]), count=torch.tensor(w["count"])),
                     time=250.0, time_delta=200, max_active=max_active)
    assert int(tm.count) == int(jm.count) < w["count"]
    assert np.array_equal(tm.data.numpy(), np.asarray(jm.data))
    snap = tsm.snapshot(tm, conf_threshold=10.0)
    assert len(snap.positions) == int(((w["data"][:, 3] > 10.0)).sum())


def test_nid_gate_matches_reference(world):
    """NID image/depth scores and overlap within 1e-5: the histograms are
    exact integer counts on both sides, only the entropy sums differ.

    Keyframe 1 against frame 3.  (Keyframe 0 of this fixture is a degenerate
    input: its rotation is about z only, so the back wall lies at exactly
    z = 2.4 m = the edge of depth bin 150 of 500, and the one-ulp difference
    between the reference's jitted transform and eager evaluation moves
    ~2800 pixels across that edge.)"""
    seq = world["seq"]
    ji, ti = world["ji"], world["ti"]

    def frame(f):
        rgb, depth = seq.frame(f)
        inten = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
        return inten, depth, seq.gt_pose(f).astype(np.float32)

    inten1, depth1, pose1 = frame(1)
    inten3, depth3, pose3 = frame(3)
    vmap3 = np.asarray(jgeo.backproject(jnp.asarray(depth3), ji))
    for stride in (1, 4):
        jr = jkf.nid_against_keyframe(
            jkf.KeyFrame(pose=jnp.asarray(pose1), intensity=jnp.asarray(inten1),
                         depth=jnp.asarray(depth1)),
            jnp.asarray(inten3), jnp.asarray(vmap3), jnp.asarray(pose3), ji,
            depth_max=8.0, stride=stride)
        tr = tkf.nid_against_keyframe(
            tkf.KeyFrame(pose=_t(pose1), intensity=_t(inten1), depth=_t(depth1)),
            _t(inten3), _t(vmap3), _t(pose3), ti, depth_max=8.0, stride=stride)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        assert 0.0 < float(tr[0]) < 1.0 and float(tr[2]) > 0.5
        np.testing.assert_allclose(tkf.nid_score(tr[0], tr[1], 0.7).numpy(),
                                   np.asarray(jkf.nid_score(jr[0], jr[1], 0.7)), atol=1e-5)


@pytest.mark.parametrize("bins,vmax", [(64, 256.0), (500, 8.0)])
def test_joint_histogram_counts_exact(rng, bins, vmax):
    a = rng.uniform(-0.1 * vmax, 1.1 * vmax, 5000).astype(np.float32)
    b = rng.uniform(0, vmax, 5000).astype(np.float32)
    valid = rng.random(5000) < 0.8
    jfn = jhist.joint_histogram_matmul if bins == 64 else jhist.joint_histogram_scatter
    ref = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), bins, vmax))
    out = thist.joint_histogram(_t(a), _t(b), _t(valid), bins, vmax).numpy()
    assert np.array_equal(out, ref)


# ---- the standalone fusion wrappers on `tests/test_map.py`'s cases ------------


def _jmap(data, count):
    return jsm.SurfelMap(data=jnp.asarray(data), count=jnp.asarray(count, jnp.int32))


def _tmap(data, count):
    return tsm.SurfelMap(data=_t(data).clone(), count=torch.tensor(int(count)))


def _maps_equal(tm, jm, atol=1e-4):
    """Counts and alive rows exact, attributes within `atol`."""
    assert int(tm.count) == int(jm.count)
    assert int(tm.num_alive()) == int(jm.num_alive())
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    for col in ("positions", "confidences", "colors", "radii", "normals", "init_times",
                "last_seen"):
        np.testing.assert_allclose(getattr(tm, col).numpy(), np.asarray(getattr(jm, col)),
                                   rtol=1e-4, atol=atol, err_msg=col)


@pytest.fixture(scope="module")
def fused(world):
    """`test_map.py`'s bootstrap (frame 0 fused into an empty map at its true
    pose) in both packages, with each frame's maps as numpy."""
    seq, ji = world["seq"], world["ji"]

    def frame(i):
        rgb, depth = seq.frame(i)
        vmap = np.asarray(jgeo.backproject(jnp.asarray(depth), ji))
        nmap = np.asarray(jgeo.normal_map(jnp.asarray(vmap)))
        return dict(rgb=rgb, depth=depth, vmap=vmap, nmap=nmap,
                    pose=seq.gt_pose(i).astype(np.float32))

    frames = {i: frame(i) for i in (0, 4, 5)}
    f0 = frames[0]
    jm, jst = jfus.fuse(jsm.empty_map(CAP), jnp.asarray(f0["vmap"]), jnp.asarray(f0["nmap"]),
                        jnp.asarray(f0["rgb"]), jnp.asarray(f0["pose"]), world["ji"], time=0)
    tm, tst = tfus.fuse(tsm.empty_map(CAP, device="cpu"), _t(f0["vmap"]), _t(f0["nmap"]),
                        _t(f0["rgb"]), _t(f0["pose"]), world["ti"], time=0)
    # numpy copies: the reference's fuse donates the map it is given
    return dict(frames=frames, jm=jm, jst=jst, tm=tm, tst=tst,
                data=np.array(jm.data), count=int(jm.count))


def test_fuse_into_empty_map_matches_reference(fused):
    """Every valid pixel of frame 0 becomes a surfel, in both packages."""
    assert tuple(int(x) for x in fused["tst"]) == tuple(int(x) for x in fused["jst"])
    assert int(fused["tst"].matched) == 0 and int(fused["tm"].count) > 0.85 * H * W
    _maps_equal(fused["tm"], fused["jm"])


def _jax_pred(data, count, pose, ji, time, window):
    """The reference's association render inside `fusion.fuse`."""
    return jsplat.render(jnp.asarray(data), jnp.asarray(count, jnp.int32), jnp.asarray(pose),
                         ji, W, H, jnp.asarray(time, jnp.float32), time_delta=200,
                         mode=jsplat.MODE_ACTIVE, window=window, packed_zbuffer=False)


def _torch_pred(jp):
    return tsplat.Prediction(*(_t(x).long() if x.dtype == jnp.int32 else _t(x) for x in jp))


@pytest.mark.parametrize(
    "frame,time,window",
    [(0, 1, 0), (4, 4, 0), (4, 300, 0), (4, 4, 1 << 12)],
    ids=["refuse-same-frame", "second-view", "second-view-late", "second-view-window"],
)
def test_fuse_matches_reference(world, fused, frame, time, window):
    """`fusion.fuse` on the bootstrapped map (`test_map.py`'s cases).  Given
    the reference's own association render, the port's fusion reproduces the
    reference's `fuse` exactly in its counts (matched / added / culled /
    dropped, the maps' counts and alive rows) and within 1e-4 in the
    attributes.  The port's whole `fuse`, with its own render, matches the
    stats within the render's parity tolerance (`test_render_matches_reference`:
    0.5% of the pixels may change winner on an f32 tie)."""
    f = fused["frames"][frame]
    kw = dict(weight_mult=0.7, cluster_id=3.0)
    jm, jst = jfus.fuse(_jmap(fused["data"], fused["count"]),
                        jnp.asarray(f["vmap"]), jnp.asarray(f["nmap"]), jnp.asarray(f["rgb"]),
                        jnp.asarray(f["pose"]), world["ji"], time=time, window=window,
                        packed_zbuffer=False, **kw)
    # at t=300 every surfel of frame 0 is inactive: nothing to match
    assert int(jst.matched) > 1000 if time < 200 else int(jst.added) > 1000
    jp = _jax_pred(fused["data"], fused["count"], f["pose"], world["ji"], time, window)
    tm, tst = tfus.fuse_with_pred(_tmap(fused["data"], fused["count"]), _torch_pred(jp),
                                  _t(f["vmap"]), _t(f["nmap"]), _t(f["rgb"]), _t(f["pose"]),
                                  world["ti"], time=time, window=window, **kw)
    assert tuple(int(x) for x in tst) == tuple(int(x) for x in jst)
    _maps_equal(tm, jm)

    tm2, tst2 = tfus.fuse(_tmap(fused["data"], fused["count"]), _t(f["vmap"]), _t(f["nmap"]),
                          _t(f["rgb"]), _t(f["pose"]), world["ti"], time=time, window=window,
                          packed_zbuffer=False, **kw)
    for a, b in zip(tst2, jst):
        assert abs(int(a) - int(b)) <= 0.005 * H * W
    assert int(tm2.count) == int(fused["count"]) + int(tst2.added)


def test_fuse_with_pred_inline_clean_matches_reference(world, fused):
    """`fuse_with_pred` with the inline clean, from the reference's own
    windowed prediction: stats exact, maps as above."""
    f = fused["frames"][5]
    data, count = fused["data"], fused["count"]
    jp = _jax_pred(data, count, f["pose"], world["ji"], 20, 1 << 12)
    tp = _torch_pred(jp)
    args = dict(time=20, window=1 << 12, conf_threshold=10.0)
    jm, jst = jfus.fuse_with_pred(_jmap(data, count), jp, jnp.asarray(f["vmap"]),
                                  jnp.asarray(f["nmap"]), jnp.asarray(f["rgb"]),
                                  jnp.asarray(f["pose"]), world["ji"],
                                  clean_depth=jnp.asarray(f["depth"]), **args)
    tm, tst = tfus.fuse_with_pred(_tmap(data, count), tp, _t(f["vmap"]), _t(f["nmap"]),
                                  _t(f["rgb"]), _t(f["pose"]), world["ti"],
                                  clean_depth=_t(f["depth"]), **args)
    assert int(jst.matched) > 1000 and int(jst.culled) > 0
    assert tuple(int(x) for x in tst) == tuple(int(x) for x in jst)
    _maps_equal(tm, jm)


def _violator(fused):
    """The bootstrapped map with `test_map.py`'s planted surfel 1 m in front
    of the far wall, dead centre of frame 0."""
    data, count = fused["data"].copy(), fused["count"]
    pose = fused["frames"][0]["pose"]
    row = np.zeros(16, np.float32)
    row[0:3] = pose[:3, :3] @ np.array([0.0, 0.0, 1.0]) + pose[:3, 3]
    row[tsm.CONF], row[tsm.RADIUS] = 5.0, 0.01
    row[8:11] = -(pose[:3, :3] @ np.array([0, 0, 1.0]))
    data[count] = row
    return data, count + 1


@pytest.mark.parametrize(
    "case,window",
    [("free-space", 0), ("stale", 0), ("free-space", 1 << 12), ("stale", 1 << 12)],
    ids=["free-space", "stale", "free-space-window", "stale-window"],
)
def test_clean_matches_reference(fused, world, case, window):
    """`fusion.clean` on `test_map.py`'s two cases (a free-space violator at
    t=1; every unstable surfel stale at t=100 with an empty depth frame):
    the same rows culled, bit for bit the same map."""
    f = fused["frames"][0]
    if case == "free-space":
        data, count = _violator(fused)
        depth, t = f["depth"], 1
    else:
        data, count = fused["data"], fused["count"]
        depth, t = np.zeros_like(f["depth"]), 100
    jm, jk = jfus.clean(_jmap(data, count), jnp.asarray(depth), jnp.asarray(f["pose"]),
                        world["ji"], time=t, window=window)
    tm, tk = tfus.clean(_tmap(data, count), _t(depth), _t(f["pose"]), world["ti"], time=t,
                        window=window)
    assert int(tk) == int(jk) >= 1
    if case == "free-space":
        assert float(tm.data[count - 1, tsm.CONF]) == 0.0
    assert np.array_equal(tm.data.numpy(), np.asarray(jm.data))
