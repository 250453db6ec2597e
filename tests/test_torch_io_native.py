"""I/O of the PyTorch port held against the JAX package on the same numpy
inputs: the native codec (built by the port into `build/native/`), `.klg`
logs and UDP frames written by either package and read by the other, the
prefetching reader, the dataset readers and ground-truth servers, and frames
streamed into the torch engine (CPU).

Every UDP socket binds an OS-assigned free port."""

import os

import numpy as np
import pytest
import torch

from densemonoslam_tpu.io import datasets as jds
from densemonoslam_tpu.io import klg as jklg
from densemonoslam_tpu.io import native as jnative
from densemonoslam_tpu.io import stream as jstream
from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io import datasets as tds
from densemonoslam_tpu_torch.io import klg as tklg
from densemonoslam_tpu_torch.io import native as tnative
from densemonoslam_tpu_torch.io import stream as tstream
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


def _frames(seq, n, start=0):
    """(rgb u8, depth u16 mm, ts) records of the synthetic orbit."""
    out = []
    for i in range(start, start + n):
        rgb, depth = seq.frame(i)
        out.append((rgb, (depth * 1000).astype(np.uint16), i * 33000))
    return out


def test_native_library_builds_into_build_dir():
    """The port compiles `native/framecodec.cpp` itself, into a hashed file
    under `build/native/`, with the prefetcher."""
    assert tnative.HAVE_NATIVE, tnative.BUILD_ERROR
    assert tnative.HAVE_PREFETCH
    lib = tnative.library_path()
    assert lib.exists() and lib.parent == tnative.BUILD_DIR
    assert str(tnative.BUILD_DIR).startswith(os.path.join(REPO, "build"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codec_bytes_cross_packages(seq, rng, writer):
    """zlib depth and JPEG RGB bytes written by either package decode to
    the same arrays in both; zlib round-trips exactly."""
    enc, dec = (jnative, tnative) if writer == "jax" else (tnative, jnative)
    depth = rng.integers(0, 5000, (120, 160)).astype(np.uint16)
    comp = enc.zlib_compress(depth)
    assert len(comp) < depth.nbytes
    for mod in (dec, enc):
        back = mod.zlib_decompress(comp, depth.nbytes).view(np.uint16).reshape(depth.shape)
        np.testing.assert_array_equal(back, depth)
    rgb, _ = seq.frame(0)
    jpg = enc.jpeg_encode(rgb, quality=95)
    a, b = dec.jpeg_decode(jpg), enc.jpeg_decode(jpg)
    np.testing.assert_array_equal(a, b)
    assert a.shape == rgb.shape and np.mean(np.abs(a.astype(int) - rgb.astype(int))) < 4.0


@pytest.mark.parametrize("compress", [True, False], ids=["zlib-jpeg", "raw"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_klg_cross_packages(seq, tmp_path, writer, compress):
    """A `.klg` written by either package reads back in the other with
    bit-equal frames (the port through its prefetcher and directly)."""
    frames = _frames(seq, 6)
    path = str(tmp_path / "x.klg")
    (jklg if writer == "jax" else tklg).write_klg(path, frames, compress=compress)
    ref = jklg.KlgReader(path, 160, 120, depth_factor=1000.0, prefetch=False)
    readers = [tklg.KlgReader(path, 160, 120, depth_factor=1000.0, prefetch=p)
               for p in (True, False)]
    assert len(ref) == 6 and all(len(r) == 6 for r in readers)
    for i, (rgb0, d0, ts0) in enumerate(frames):
        j = ref.get_next()
        for r in readers:
            got = r.get_next()
            np.testing.assert_array_equal(got[0], j[0])
            np.testing.assert_array_equal(got[1], j[1])
            assert got[2] == j[2] == float(ts0)
        np.testing.assert_array_equal(j[1], d0 / np.float32(1000.0))
        if not compress:
            np.testing.assert_array_equal(j[0], rgb0)
    assert not any(r.has_more() for r in readers)
    readers[0].close()


def test_klg_prefetcher_matches_direct(tmp_path, rng):
    """Mirror of `test_klg_prefetcher_matches_direct`: the prefetching reader
    delivers the direct path's frames, strictly in order."""
    H, W, N = 48, 64, 24
    frames = [(rng.integers(0, 255, (H, W, 3)).astype(np.uint8),
               rng.integers(100, 4000, (H, W)).astype(np.uint16), i * 33000) for i in range(N)]
    path = str(tmp_path / "pf.klg")
    tklg.write_klg(path, frames, compress=True)
    direct = tklg.KlgReader(path, W, H, prefetch=False)
    pre = tklg.KlgReader(path, W, H, prefetch=True)
    for _ in range(N):
        r1, d1, t1 = direct.get_next()
        r2, d2, t2 = pre.get_next()
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        assert t1 == t2
    pre.close()


def test_klg_prefetcher_rewind_fast_forward(tmp_path):
    """Mirror of `test_klg_prefetcher_rewind_fast_forward`: random access
    re-syncs the stream; going back after reading ahead does not deadlock."""
    H, W, N = 32, 40, 12
    frames = [(np.full((H, W, 3), i * 10, np.uint8), np.full((H, W), 100 + i, np.uint16), i)
              for i in range(N)]
    path = str(tmp_path / "ff.klg")
    tklg.write_klg(path, frames, compress=False)
    r = tklg.KlgReader(path, W, H, prefetch=True)
    r.fast_forward(7)
    rgb, depth, ts = r.get_next()
    assert ts == 7 and depth[0, 0] * r.depth_factor == pytest.approx(107)
    r.rewind()
    rgb, depth, ts = r.get_next()
    assert ts == 0 and rgb[0, 0, 0] == 0
    r.fast_forward(3)
    assert r.get_next()[2] == 3
    r.rewind()
    assert r.get_next()[2] == 0
    r.close()


def test_stream_payload_bytes_equal(seq):
    """The UDP payload of a raw frame is byte for byte the JAX package's; a
    compressed payload of either package decodes to the same frame in both
    (its JPEG bytes depend on which codec each package has loaded)."""
    rgb, depth = seq.frame(3)
    d16 = (depth * 1000).astype(np.uint16)
    args = ("camX", rgb, d16, 5, 123456)
    assert tstream._encode_payload(*args, compress=False, last=True) == (
        jstream._encode_payload(*args, compress=False, last=True))
    for enc in (jstream, tstream):
        payload = enc._encode_payload(*args, compress=True, last=True)
        fj, ft = jstream._decode_payload(payload), tstream._decode_payload(payload)
        assert {k: v for k, v in fj.items() if k not in ("rgb", "depth")} == {
            k: v for k, v in ft.items() if k not in ("rgb", "depth")
        }
        assert ft["sender"] == "camX" and ft["last"] and ft["timestamp"] == 123456
        np.testing.assert_array_equal(fj["rgb"], ft["rgb"])
        np.testing.assert_array_equal(ft["depth"], d16)


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_udp_stream_two_senders(seq, sender):
    """Mirror of `test_udp_stream_two_senders` across the packages: two
    cameras of one package stream over loopback to the other's receiver,
    which demuxes them by sender."""
    tx_mod, rx_mod = (jstream, tstream) if sender == "jax" else (tstream, jstream)
    rx = rx_mod.FrameReceiver(port=0)
    mgr = rx_mod.StreamCameraManager(rx, depth_factor=1000.0)
    try:
        tx_a = tx_mod.FrameSender("camA", port=rx.port)
        tx_b = tx_mod.FrameSender("camB", port=rx.port)
        for i in range(3):
            rgb, depth = seq.frame(i)
            d16 = (depth * 1000).astype(np.uint16)
            tx_a.send(rgb, d16, timestamp=i)
            tx_b.send(rgb, d16, timestamp=10 + i, last=(i == 2))
        assert mgr.wait_for_cameras(2, timeout=5.0)
        assert sorted(mgr.cameras()) == ["camA", "camB"]
        rgb_a, depth_a, ts_a = mgr.get_next("camA", timeout=2.0)
        assert ts_a == 0.0
        ref_rgb, ref_depth = seq.frame(0)
        assert np.mean(np.abs(rgb_a.astype(int) - ref_rgb.astype(int))) < 5.0
        np.testing.assert_allclose(depth_a, (ref_depth * 1000).astype(np.uint16) / 1000.0,
                                   atol=1e-6)
        for _ in range(3):
            mgr.get_next("camB", timeout=2.0)
        assert mgr.finished("camB")
        tx_a.close()
        tx_b.close()
    finally:
        rx.close()


def test_stream_into_engine(seq):
    """Mirror of `test_stream_into_engine` on the torch engine: frames
    streamed over UDP straight into the SLAM engine (CPU)."""
    rx = tstream.FrameReceiver(port=0)
    mgr = tstream.StreamCameraManager(rx, depth_factor=1000.0)
    try:
        tx = tstream.FrameSender("live0", port=rx.port)
        for i in range(4):
            rgb, depth = seq.frame(i)
            tx.send(rgb, (depth * 1000).astype(np.uint16), timestamp=i)
        assert mgr.wait_for_cameras(1)
        cfg = EngineConfig(max_surfels=1 << 16, depth_cutoff=8.0, depth_factor=1000.0,
                           nid_keyframing=False, open_loop=True)
        eng = Engine(seq.camera, cfg, device="cpu")
        eng.frontend("live0").pose = seq.gt_pose(0).astype(np.float32)
        n = 0
        while n < 4:
            got = mgr.get_next("live0", timeout=2.0)
            if got is None:
                break
            rgb, depth_m, ts = got
            info = eng.process_frame("live0", rgb, depth_m * 1000.0, ts)
            assert info["tracking_ok"] == 1.0
            n += 1
        assert n == 4
        assert eng.surfel_count("live0") > 1000
        tx.close()
    finally:
        rx.close()


def test_dataset_readers_match_reference(seq, tmp_path):
    """The TUM and ICL-NUIM readers on one directory of 16-bit PNGs, and the
    freiburg trajectory and ground-truth pose server, equal the JAX
    package's."""
    from PIL import Image

    from densemonoslam_tpu_torch.io.writers import save_freiburg

    root = tmp_path / "seq"
    for d in ("rgb", "depth"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(3):
        rgb, depth = seq.frame(i)
        Image.fromarray(rgb).save(root / "rgb" / f"{i}.png")
        Image.fromarray((depth * 5000).astype(np.uint16)).save(root / "depth" / f"{i}.png")
        lines.append(f"{i * 0.033:.6f} rgb/{i}.png {i * 0.033:.6f} depth/{i}.png")
    (root / "assoc.txt").write_text("# ts rgb ts depth\n" + "\n".join(lines) + "\n")
    for jr, tr in ((jds.TumRgbdReader(str(root)), tds.TumRgbdReader(str(root))),
                   (jds.IclNuimReader(str(root)), tds.IclNuimReader(str(root)))):
        assert len(jr) == len(tr) == 3
        while jr.has_more():
            a, b = jr.get_next(), tr.get_next()
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
        assert not tr.has_more()
    traj = str(tmp_path / "gt.freiburg")
    save_freiburg(traj, [0.0, 1.0, 2.0], [seq.gt_pose(i) for i in (0, 5, 10)])
    jts, jposes = jds.load_freiburg_trajectory(traj)
    tts, tposes = tds.load_freiburg_trajectory(traj)
    np.testing.assert_array_equal(tts, jts)
    np.testing.assert_array_equal(tposes, jposes)
    jo, to = jds.GroundTruthOdometry(traj), tds.GroundTruthOdometry(traj)
    for t in (-1.0, 0.0, 0.3, 0.7, 1.5, 9.0):
        np.testing.assert_array_equal(to.pose_at(t), jo.pose_at(t))


def test_ground_truth_clusters(tmp_path):
    """Mirror of `test_io.py::test_ground_truth_clusters`, and the same ids
    and colours as the JAX package's."""
    p = tmp_path / "clusters.csv"
    p.write_text("100,0\n200,1\n300,2\n")
    gtc = tds.GroundTruthClusters(str(p))
    assert gtc.cluster_at(100) == 0
    assert gtc.cluster_at(250) == 1
    assert gtc.cluster_at(999) == 2
    assert gtc.cluster_at(50) == 0  # before first entry
    assert set(gtc.cluster_colors) == {0, 1, 2}
    for rgb in gtc.cluster_colors.values():
        assert all(0.0 <= v <= 1.0 for v in rgb)
    assert gtc.cluster_colors == jds.GroundTruthClusters(str(p)).cluster_colors


def test_cluster_tagged_fusion_and_ply(tmp_path):
    """Mirror of `test_io.py::test_cluster_tagged_fusion_and_ply` on the
    torch engine: surfels carry the frame's cluster id; the PLY export
    filters by it."""
    seq = SyntheticSequence(num_frames=24)
    cfg = EngineConfig(max_surfels=1 << 16, depth_cutoff=8.0, depth_factor=1.0,
                       open_loop=True, nid_keyframing=False)
    eng = Engine(seq.camera, cfg, device="cpu")
    eng.frontend("cam0").pose = seq.gt_pose(0).astype(np.float32)
    for i in range(6):
        rgb, depth = seq.frame(i)
        info = eng.process_frame("cam0", rgb, depth, float(i), cluster=i // 3)
        assert info["tracking_ok"] == 1.0
    snap = sm.snapshot(eng.map_of("cam0"))
    assert set(np.unique(snap.clusters).tolist()) == {0, 1}
    n0 = eng.save_ply("cam0", str(tmp_path / "c0.ply"), stable_only=False, cluster=0)
    n1 = eng.save_ply("cam0", str(tmp_path / "c1.ply"), stable_only=False, cluster=1)
    nall = eng.save_ply("cam0", str(tmp_path / "all.ply"), stable_only=False)
    assert n0 > 0 and n1 > 0 and n0 + n1 == nall
