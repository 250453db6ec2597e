"""Tests of the PyTorch port that need an NVIDIA GPU (marked `cuda`; they
skip where `torch.cuda.is_available()` is false).  This file imports no jax,
so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from densemonoslam_tpu_torch.config import EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import deformation as tdg
from densemonoslam_tpu_torch.ops import cuda_build
from densemonoslam_tpu_torch.ops import deform as tdeform
from densemonoslam_tpu_torch.ops import gram as tgram
from densemonoslam_tpu_torch.utils import launches as klaunches

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("P,C", [(76800, 16), (19200, 16), (4800, 16), (4800, 8), (5000, 8), (0, 8)])
def test_gram_kernel_matches_reference(cuda, P, C):
    """K1 against `gram_reference` in f64 at the tracking shapes (rtol 2e-5
    / atol 1e-2, `tests/test_pallas.py`'s tolerance), bit-identical from run
    to run and under zero padding."""
    M = torch.from_numpy(np.random.default_rng(P + C).normal(0, 1, (P, C)).astype(np.float32))
    M = M.to(cuda)
    before = klaunches.total("gram")
    out = tgram.gram(M)
    again = tgram.gram(M)
    padded = tgram.gram(torch.cat([M, torch.zeros(3000, C, device=cuda)]))
    torch.cuda.synchronize()
    assert klaunches.total("gram") == before + 3
    ref = tgram.gram_reference(M.double()).cpu().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=2e-5, atol=1e-2)
    assert torch.equal(out, again)
    assert torch.equal(out, padded)


@pytest.mark.parametrize("P,C", [(76800, 16), (4800, 8)])
def test_gram_kernel_one_launch_per_call(cuda, P, C):
    """One call is one device kernel and nothing else (no memset, no copy,
    no second pass), counted from a CUDA graph of the call."""
    M = torch.randn(P, C, device=cuda)
    assert cuda_build.kernels_per_call(lambda: tgram.gram(M)) == (1, 1)


# rows per chunk: 128 at C = 16, 256 at C = 8; 128 blocks, so a block walks
# a second chunk from 16384 rows (C = 16) and 32768 rows (C = 8)
@pytest.mark.parametrize("P,C", [(1, 16), (127, 16), (129, 16), (255, 8), (257, 8),
                                 (16385, 16), (32769, 8)])
def test_gram_kernel_zero_padding_and_reruns(cuda, P, C):
    """Bit-identical reruns and bit-identical results under 1 to 40000
    appended zero rows: the padding ends a ragged chunk, adds whole zero
    chunks, and (from small P) pushes P past 128 blocks x one chunk."""
    gen = np.random.default_rng(P * C)
    M = torch.from_numpy(gen.normal(0, 1, (P, C)).astype(np.float32)).to(cuda)
    out = tgram.gram(M)
    assert torch.equal(out, tgram.gram(M))
    for pad in (1, 127, 3000, 40000):
        padded = tgram.gram(torch.cat([M, torch.zeros(pad, C, device=cuda)]))
        assert torch.equal(out, padded), pad
    ref = tgram.gram_reference(M.double()).cpu().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=2e-5, atol=1e-2)


def test_gram_kernel_streams_keep_their_tickets(cuda):
    """Back-to-back calls on one stream (the last block resets the ticket)
    and interleaved calls on two streams without a synchronise in between
    (each stream has its own scratch and ticket) all give the same bits."""
    M = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (19200, 16)).astype(np.float32))
    M = M.to(cuda)
    ref = tgram.gram(M)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(20):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                outs.append(tgram.gram(M))
                outs.append(tgram.gram(M))
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in outs)


def test_gram_kernel_rejects_bad_input_on_cuda(cuda):
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(64, 12, device=cuda))
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(64, 8, device=cuda, dtype=torch.float16))
    unaligned = torch.zeros(64 * 16 + 1, device=cuda)[1:].view(64, 16)  # 4 bytes past 16
    assert unaligned.is_contiguous()
    with pytest.raises(ValueError):
        tgram.gram(unaligned)


def test_engine_on_cuda_matches_cpu(cuda):
    """Eight frames of the 160x120 engine on the GPU and on the CPU: poses
    within 0.5 mm / 1e-3 rad (different summation orders in the Gram and
    the reductions), the GPU run through the kernel."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0,
                       open_loop=True, nid_keyframing=False)
    poses = {}
    for dev in ("cpu", cuda):
        eng = Engine(seq.camera, cfg, device=dev)
        eng.frontend("cam0").pose = seq.gt_pose(0).astype(np.float32)
        before = klaunches.total("gram")
        for i in range(8):
            info = eng.process_frame("cam0", *seq.frame(i), float(i))
            assert info["tracking_ok"] == 1.0
        launched = klaunches.total("gram") - before
        poses[str(dev)] = np.stack([p for _, p in eng.frontends["cam0"].trajectory])
    assert launched >= 8 * 29  # every SO3 and GN iteration of the GPU run
    for a, b in zip(poses["cuda"], poses["cpu"]):
        dT = np.linalg.inv(b) @ a
        assert np.linalg.norm(dT[:3, 3]) < 5e-4
        assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-3


def _deform_case(N, K, seed):
    """A map of N rows (10% dead, live rows past `count`, every column
    filled) and a K-node graph with sorted times, some invalid nodes."""
    gen = np.random.default_rng(seed)
    data = np.zeros((N + 1, 16), np.float32)
    data[:N, 0:3] = gen.uniform(-3, 3, (N, 3))
    data[:N, 3] = gen.uniform(0.5, 20, N) * (gen.random(N) > 0.1)
    data[:N, 4:8] = gen.uniform(0, 255, (N, 4))
    nrm = gen.normal(size=(N, 3))
    data[:N, 8:11] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    data[:N, 11] = np.floor(gen.uniform(-5, 205, N))
    data[:N, 12:16] = gen.uniform(0, 200, (N, 4))
    nv = K - K // 16
    pos = np.zeros((K, 3), np.float32)
    pos[:nv] = gen.uniform(-3, 3, (nv, 3))
    time = np.full(K, np.inf, np.float32)
    time[:nv] = np.sort(np.floor(gen.uniform(0, 200, nv)))
    valid = np.zeros(K, bool)
    valid[:nv] = gen.random(nv) > 0.05
    A = (np.eye(3)[None] + 0.05 * gen.normal(size=(K, 3, 3))).astype(np.float32)
    t = (0.05 * gen.normal(size=(K, 3))).astype(np.float32)
    return data, N - 777, dict(pos=pos, time=time, valid=valid, A=A, t=t)


@pytest.mark.parametrize("N,K", [(1 << 16, 128), (1 << 20, 256), (1 << 20, 512)])
def test_deform_kernel_matches_reference(cuda, N, K):
    """K2 against `deform_map_reference` on the same map: positions and
    normals within 1e-4 (both subtract before squaring; the kernel contracts
    multiply-adds and blends in registers: f32 rounding over ~20 dependent
    operations at coordinates <= 3 m), reruns bit-identical, every byte
    outside the live rows' positions and normals unchanged; the all-invalid
    graph passes everything through."""
    data, count, g = _deform_case(N, K, N + K)
    d = torch.from_numpy(data).to(cuda)
    c = torch.full((), count, dtype=torch.int64, device=cuda)
    graph = tdg.graph_from_numpy(g, cuda)
    before = klaunches.total("deform")
    out = tdeform.deform_map(d.clone(), c, graph)
    again = tdeform.deform_map(d.clone(), c, graph)
    ref = tdeform.deform_map_reference(d.clone(), c, graph)
    torch.cuda.synchronize()
    assert klaunches.total("deform") == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    alive = torch.zeros(N + 1, dtype=torch.bool, device=cuda)
    alive[:count] = d[:count, 3] > 0
    assert torch.equal(out[~alive], d[~alive])
    other = [3, 4, 5, 6, 7, 11, 12, 13, 14, 15]
    assert torch.equal(out[:, other], d[:, other])
    assert (out[alive][:, 0:3] != d[alive][:, 0:3]).any()
    assert torch.equal(tdeform.deform_map(d.clone(), c, tdg.empty_graph(K, cuda)), d)


def test_deform_kernel_two_launches_per_call(cuda):
    """One call is K2's two kernels (the node-table prologue, then the map
    kernel) and nothing else, counted from a CUDA graph of the call."""
    data, count, g = _deform_case(1 << 12, 64, 3)
    d = torch.from_numpy(data).to(cuda)
    c = torch.full((), count, dtype=torch.int64, device=cuda)
    graph = tdg.graph_from_numpy(g, cuda)
    assert cuda_build.kernels_per_call(lambda: tdeform.deform_map(d, c, graph)) == (2, 2)


@pytest.mark.parametrize("K", [128, 512])
def test_deform_kernel_paths_agree_bit_for_bit(cuda, K):
    """Node times with many ties (the K nodes over 12 ticks) and one map
    laid out twice: sorted by creation time, so nearly every warp's rows
    share one window (the uniform path), and shuffled, so warps straddle
    windows (the per-thread path).  Each layout matches
    `deform_map_reference` within 1e-4 and reruns bit for bit, and every row
    gets the same bits in both layouts."""
    data, count, g = _deform_case(1 << 18, K, K)
    gen = np.random.default_rng(K + 1)
    nv = K - K // 16
    g["time"][:nv] = np.sort(np.floor(gen.uniform(0, 12, nv)))
    data[:count, 11] = np.floor(gen.uniform(-1, 13, count))
    order = np.argsort(data[:count, 11], kind="stable")
    shuffle = gen.permutation(count)
    c = torch.full((), count, dtype=torch.int64, device=cuda)
    graph = tdg.graph_from_numpy(g, cuda)
    outs = {}
    for name, perm in [("sorted", order), ("shuffled", shuffle)]:
        laid = data.copy()
        laid[:count] = data[perm]
        d = torch.from_numpy(laid).to(cuda)
        out = tdeform.deform_map(d.clone(), c, graph)
        again = tdeform.deform_map(d.clone(), c, graph)
        ref = tdeform.deform_map_reference(d.clone(), c, graph)
        torch.cuda.synchronize()
        assert torch.equal(out, again), name
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
        back = torch.empty_like(out)
        back[torch.from_numpy(perm).to(cuda)] = out[:count]
        outs[name] = back[:count]
    assert torch.equal(outs["sorted"], outs["shuffled"])


def test_deform_kernel_equal_distances_take_lower_index(cuda):
    """Nodes in runs of 6 at one position (each with its own A and t), so
    every row sees runs of exactly equal distances: of equally near nodes
    the lower index is kept (`lax.top_k`'s order, the plain version's stable
    sort), on both of the kernel's paths (rows in index order and in time
    order); an insertion that let a displaced node pass an equal one would
    blend other nodes' A and t, far outside 1e-4."""
    data, count, g = _deform_case(1 << 16, 240, 5)
    g["pos"][:225] = np.repeat(g["pos"][0:225:6], 6, axis=0)[:225]
    g["valid"][:225] = True
    c = torch.full((), count, dtype=torch.int64, device=cuda)
    graph = tdg.graph_from_numpy(g, cuda)
    for order in (np.arange(count), np.argsort(data[:count, 11], kind="stable")):
        laid = data.copy()
        laid[:count] = data[order]
        d = torch.from_numpy(laid).to(cuda)
        out = tdeform.deform_map(d.clone(), c, graph)
        ref = tdeform.deform_map_reference(d.clone(), c, graph)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_deform_kernel_rejects_bad_input_on_cuda(cuda):
    d = torch.zeros(65, 16, device=cuda)
    c = torch.zeros((), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        tdeform.deform_map(d, c, tdg.empty_graph(tdeform.MAX_NODES + 1, cuda))
    with pytest.raises(ValueError):
        tdeform.deform_map(d, c.cpu(), tdg.empty_graph(8, cuda))
    with pytest.raises(ValueError):
        tdeform.deform_map(d, c, tdg.empty_graph(8, "cpu"))


def test_closed_loop_engine_on_cuda_matches_cpu(cuda):
    """The two-epoch revisit of `tests/test_loops.py` (ground truth, then an
    8 cm drift 100 ticks later, loop checks every 5 frames) on the GPU and on
    the CPU: the closure lands on the same frame, the GPU's through K2, and
    the corrected trajectories agree within 1 mm (the closure's graph comes
    from tracking whose sums run in another order on each device)."""
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(
        max_surfels=1 << 18, depth_cutoff=8.0, depth_factor=1.0, nid_keyframing=False,
        open_loop=False, loop_check_interval=5, time_delta=50, deform_graph_sample_rate=600,
        max_deform_nodes=128, loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
        confidence_threshold=1.0,
    )
    runs = {}
    for dev in ("cpu", cuda):
        eng = Engine(seq.camera, cfg, device=dev)
        fe = eng.frontend("cam0")
        fe.pose = seq.gt_pose(0).astype(np.float32)
        launches = klaunches.total("deform")
        for i in range(10):
            eng.process_frame("cam0", *seq.frame(i), float(i), in_pose=seq.gt_pose(i).astype(np.float32))
        eng.global_tick = 100
        closed_at = None
        for i in range(10):
            pose = seq.gt_pose(i).astype(np.float32)
            pose[:3, 3] += np.array([0.08, 0.0, 0.0], np.float32)
            eng.process_frame("cam0", *seq.frame(i), float(100 + i), in_pose=pose)
            if fe.loops_closed:
                closed_at = i
                break
        runs[str(dev)] = (closed_at, np.stack([p for _, p in fe.trajectory]),
                          klaunches.total("deform") - launches)
    assert runs["cuda"][0] is not None and runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][2] >= 1 and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][1][:, :3, 3], runs["cpu"][1][:, :3, 3], atol=1e-3)


# ---------------------------------------------------------------- monocular


def _intensity(rgb: np.ndarray) -> np.ndarray:
    r = rgb.astype(np.float32)
    return (0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]).astype(np.float32)


def test_depthnet_on_cuda_matches_cpu(cuda):
    """The packaged street net at the KITTI operating size (1024x320) on the
    GPU and on the CPU: depths within 1e-4 relative (cuDNN's f32
    convolutions sum in another order; TF32 is off)."""
    from densemonoslam_tpu_torch.models.depthnet import DepthPredictor

    rgb = np.random.default_rng(0).integers(0, 256, (320, 1024, 3)).astype(np.uint8)
    a = DepthPredictor.pretrained_street(device=cuda).predict(rgb)
    b = DepthPredictor.pretrained_street(device="cpu").predict(rgb)
    assert a.device.type == "cuda"
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4)


def _tiny_training_batch():
    """`tests/test_depthnet.py`'s tiny scene (48x64): 4 views as f32 RGB in
    [0, 1] and depth."""
    from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution

    cam = CameraConfig(FrameResolution(64, 48), CameraIntrinsics(52.0, 52.0, 31.5, 23.5), "tiny")
    seq = SyntheticSequence(camera=cam, num_frames=12, radius=0.3, max_angle=0.25)
    frames = [seq.frame(i) for i in range(4)]
    rgb = torch.from_numpy(np.stack([f[0] for f in frames]).astype(np.float32) / 255.0)
    return rgb, torch.from_numpy(np.stack([f[1] for f in frames]))


def test_depthnet_gradients_on_cuda_match_cpu(cuda):
    """The train leg's card-against-CPU check at the tiny size (widths (8,
    16, 24)): from one flax-style initialisation (seed 0) and one batch,
    every parameter's gradient of `l1_depth_loss` on the card within 1e-3
    relative norm of the CPU's (cuDNN sums in another order; TF32 is off).
    The conv biases that a one-channel-per-group GroupNorm cancels have no
    true gradient: on both devices they stay below 1e-5 of their kernel's."""
    from densemonoslam_tpu_torch.models import depthnet as tdn

    rgb, gt = _tiny_training_batch()
    grads = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        net = tdn.DepthNet((8, 16, 24), 0.3, 10.0, seed=0).to(dev)
        tdn.l1_depth_loss(net(rgb.to(dev).permute(0, 3, 1, 2)), gt.to(dev)).backward()
        grads[key] = {k: p.grad.double().cpu() for k, p in net.named_parameters()}
    cancelled = {f"blocks.{i}.conv.bias" for i, b in enumerate(net.blocks)
                 if b.norm.num_groups == b.norm.num_channels}
    assert cancelled  # the width-8 blocks
    for name, g in grads["cpu"].items():
        on_card = grads["card"][name]
        if name in cancelled:
            kernel = float(grads["cpu"][name.replace("bias", "weight")].norm())
            assert float(g.norm()) < 1e-5 * kernel and float(on_card.norm()) < 1e-5 * kernel, name
        else:
            assert float((on_card - g).norm() / g.norm()) <= 1e-3, name


def test_depthnet_train_steps_on_cuda_match_cpu(cuda):
    """5 `make_train_step` steps (Adam 3e-3) on one tiny batch from one
    initialisation: the card's losses within 1e-3 relative of the CPU's,
    each returned as a 0-dim tensor on the card."""
    from densemonoslam_tpu_torch.models import depthnet as tdn

    rgb, gt = _tiny_training_batch()
    losses = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        net = tdn.DepthNet((8, 16, 24), 0.3, 10.0, seed=0).to(dev)
        step = tdn.make_train_step(net, torch.optim.Adam(net.parameters(), lr=3e-3))
        out = [step(rgb.to(dev), gt.to(dev)) for _ in range(5)]
        assert all(o.device.type == torch.device(dev).type and o.dim() == 0 for o in out)
        losses[key] = torch.stack(out).cpu().numpy()
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-3)


def test_detector_on_cuda_matches_cpu(cuda):
    """`detect_and_describe` and `detect_pyramid` on a 1024x320 street frame
    on the GPU and on the CPU: octave 0 identical in its keypoint slots,
    validity and depth, angles within 1e-4 and >= 99% of the valid
    descriptors bit-equal; every octave's valid keypoints overlap >= 95%
    (the antialiased resizes round differently on each device)."""
    from densemonoslam_tpu_torch.config import CameraConfig
    from densemonoslam_tpu_torch.io.street import StreetSequence
    from densemonoslam_tpu_torch.tracking import sparse

    rgb, depth = StreetSequence(CameraConfig.kitti_default(), exposure_jitter=0.03).frame(40)
    inten, depth = torch.from_numpy(_intensity(rgb)), torch.from_numpy(depth)
    kc = sparse.detect_and_describe(inten.to(cuda), depth.to(cuda))
    kh = sparse.detect_and_describe(inten, depth)
    v = kh.valid.numpy()
    assert v.sum() > 300
    np.testing.assert_array_equal(kc.valid.cpu().numpy(), v)
    np.testing.assert_array_equal(kc.uv.cpu().numpy(), kh.uv.numpy())
    np.testing.assert_array_equal(kc.depth.cpu().numpy(), kh.depth.numpy())
    np.testing.assert_allclose(kc.angle.cpu().numpy()[v], kh.angle.numpy()[v], atol=1e-4)
    same = (kc.desc.cpu().numpy()[v] == kh.desc.numpy()[v]).all(axis=1)
    assert same.mean() >= 0.99
    pc, ph = sparse.detect_pyramid(inten.to(cuda), depth.to(cuda)), sparse.detect_pyramid(inten, depth)
    o = 0
    for q in sparse._octave_quotas(sparse.OCTAVES, sparse.SCALE_FACTOR, sparse.MAX_KEYPOINTS):
        a = {tuple(p) for p, ok in zip(pc.uv.cpu().numpy()[o:o + q], pc.valid.cpu().numpy()[o:o + q]) if ok}
        b = {tuple(p) for p, ok in zip(ph.uv.numpy()[o:o + q], ph.valid.numpy()[o:o + q]) if ok}
        assert len(a & b) >= 0.95 * len(a | b)
        o += q


def test_ba_and_pgo_on_cuda_are_deterministic(cuda):
    """`bundle_adjust` and `optimise_pose_graph` each run twice on the GPU
    give the same bits (their sums are one-hot products, never float-atomic
    scatters)."""
    from densemonoslam_tpu_torch.config import CameraIntrinsics
    from densemonoslam_tpu_torch.parallel import ba
    from densemonoslam_tpu_torch.utils import se3

    gen = np.random.default_rng(7)
    W, Pn, KP = 6, 512, 512
    poses = se3.se3_exp(torch.from_numpy(gen.normal(0, 0.05, (W, 6)).astype(np.float32)))
    pts = np.stack([gen.uniform(-5, 5, Pn), gen.uniform(-2, 2, Pn), gen.uniform(5, 30, Pn)], -1)
    O = W * KP
    problem = ba.BAProblem(
        poses=poses.to(cuda),
        points=torch.from_numpy(pts.astype(np.float32)).to(cuda),
        cam_idx=torch.from_numpy(np.repeat(np.arange(W), KP)).to(cuda),
        pnt_idx=torch.from_numpy(gen.integers(0, Pn, O)).to(cuda),
        uv=torch.from_numpy(gen.uniform(0, 1024, (O, 2)).astype(np.float32)).to(cuda),
        valid=torch.from_numpy(gen.random(O) > 0.2).to(cuda),
        z=torch.from_numpy(gen.uniform(0, 30, O).astype(np.float32)).to(cuda),
    )
    intr = CameraIntrinsics(707.09, 707.09, 601.89, 183.11)
    runs = [ba.bundle_adjust(problem, intr, iters=4, fix_cameras=1, damping=1e-2, huber=3.0)
            for _ in range(2)]
    assert torch.equal(runs[0][0].poses, runs[1][0].poses)
    assert torch.equal(runs[0][0].points, runs[1][0].points)
    K, E = 256, 512
    kp = se3.se3_exp(torch.from_numpy(gen.normal(0, 0.3, (K, 6)).astype(np.float32))).to(cuda)
    ei = torch.from_numpy(np.concatenate([np.arange(K - 1), gen.integers(0, K, E - K + 1)])).to(cuda)
    ej = torch.from_numpy(np.concatenate([np.arange(1, K), gen.integers(0, K, E - K + 1)])).to(cuda)
    Z = se3.se3_inverse(kp[ei]) @ kp[ej] @ se3.se3_exp(torch.randn(E, 6, device=cuda) * 0.01)
    edges = ba.PoseGraphEdges(i=ei, j=ej, Z=Z, weight=torch.ones(E, device=cuda))
    outs = [ba.optimise_pose_graph(kp, edges, cg_iters=128) for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_sparse_track_without_flush_makes_no_sync(cuda):
    """A `SparseTracker.track` call that does not flush queues device work
    only: zero host synchronisations (CUDA sync debug mode)."""
    import warnings

    from densemonoslam_tpu_torch.tracking.sparse import SparseTracker

    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    frames = [(torch.from_numpy(_intensity(r)).to(cuda), torch.from_numpy(d).to(cuda))
              for r, d in (seq.frame(i) for i in range(3))]
    trk = SparseTracker(seq.camera.intrinsics, device=cuda)
    trk.pose = seq.gt_pose(0).astype(np.float32)
    trk.track(*frames[0])  # the first frame inserts the first keyframe (one read)
    trk.track(*frames[1])
    torch.cuda.synchronize()
    assert len(trk._pending) == 1 < trk.flush_interval - 1
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trk.track(*frames[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(trk._pending) == 2
    assert sum("synchroniz" in str(w.message) for w in caught) == 0


def test_bounded_pacing_waits_on_frame_t_minus_8(cuda, monkeypatch):
    """On the card the engine's bounded pacing records one CUDA event per
    frame and, every 4 frames once more than 8 stats rows are logged, waits
    on the event of the frame 8 rows back (`densemonoslam_tpu/engine.py:
    502-509`), and on no other.  The step is replaced by one that returns a
    stats row, so that nothing else waits."""
    from densemonoslam_tpu_torch import engine as engmod

    seq = SyntheticSequence(num_frames=2)
    rgb, depth = (torch.from_numpy(x).to(cuda) for x in seq.frame(0))
    eng = Engine(seq.camera, EngineConfig(max_surfels=1 << 10, open_loop=True), device=cuda)
    fe = eng.frontend("cam0")
    fe.step_fn = lambda state, *a: (state, torch.zeros(29, device=cuda))
    waited = []
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda ev: waited.append(ev))
    made, fired = [], {}
    for i in range(21):
        n = len(waited)
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        made.append(fe.frame_events[-1])
        if len(waited) > n:
            fired[fe.tick] = waited[n:]
    assert sorted(fired) == [12, 16, 20]
    for tick, evs in fired.items():
        assert len(evs) == 1 and evs[0] is made[tick - 8]
    assert len(fe.frame_events) == engmod._PACING_LAG


# ------------------------------------------------------------ CUDA graphs

# `tests/test_torch_graph.py`'s frame order: frame 5 shows the orbit's frame
# 11 (tracking fails: a render without fusion), frame 7 its frame 18 (the
# finer levels starve on the CPU)
GRAPH_ORDER = [0, 1, 2, 3, 4, 11, 6, 18, 8, 9]


def _graph_case(cuda):
    """The 96x128 orbit at `__graft_entry__.entry()`'s configuration (1<<14
    rows, NID keyframing, open loop) as device frames in `GRAPH_ORDER`."""
    from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution

    H, W = 96, 128
    intr = CameraIntrinsics(100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5)
    seq = SyntheticSequence(camera=CameraConfig(FrameResolution(W, H), intr, "graph"),
                            num_frames=40, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(max_surfels=1 << 14, depth_cutoff=100.0, depth_factor=1.0,
                       nid_keyframing=True, open_loop=True)
    frames = [tuple(torch.from_numpy(x).to(cuda) for x in seq.frame(f)) for f in GRAPH_ORDER]
    return seq, intr, cfg, frames


def test_graphed_step_matches_eager(cuda):
    """Ten frames through the graphed step and through the eager step from
    one initial state (fuse, no-render, render-only and starved frames):
    every stats row within 1e-5 (flags and counts exact), the same
    surfels; no host synchronisation inside a replay (sync debug mode
    "error"); the K1 launches counted through the replays of frames 1-9,
    settled, equal the eager run's."""
    from densemonoslam_tpu_torch import step as tstep
    from densemonoslam_tpu_torch.utils import graphs

    seq, intr, cfg, frames = _graph_case(cuda)
    eye = torch.eye(4, device=cuda)
    rows, launches, runs = {}, {}, {}
    for mode in ("eager", "graphed"):
        make = tstep.make_step if mode == "eager" else tstep.make_graphed_step
        fn = make(intr, 96, 128, cfg)
        st = tstep.init_state(1 << 14, 96, 128, device=cuda)
        st.pose = torch.from_numpy(seq.gt_pose(0).astype(np.float32)).to(cuda)
        out = []
        for k, (rgb, depth) in enumerate(frames):
            if k == 1:
                torch.cuda.synchronize()
                graphs.settle_counts()
                before, runs0 = klaunches.total("gram"), dict(graphs.BRANCH_RUNS)
            st = st.replace(tick=torch.full((), k, dtype=torch.int64, device=cuda))
            if mode == "graphed" and k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                st, stats = fn(st, rgb, depth, eye, False, 1.0, 0.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out.append(stats.clone())
        torch.cuda.synchronize()
        graphs.settle_counts()
        launches[mode] = klaunches.total("gram") - before
        runs[mode] = {k: v - runs0.get(k, 0) for k, v in graphs.BRANCH_RUNS.items()
                      if v != runs0.get(k, 0)}
        rows[mode] = torch.stack(out).cpu().numpy()
    exact = [tstep.STAT_TRACK_OK, tstep.STAT_FUSED, tstep.STAT_MATCHED, tstep.STAT_ADDED,
             tstep.STAT_CULLED, tstep.STAT_SURFELS, tstep.STAT_KEYFRAMES, tstep.STAT_DROPPED]
    np.testing.assert_array_equal(rows["graphed"][:, exact], rows["eager"][:, exact])
    np.testing.assert_allclose(rows["graphed"], rows["eager"], rtol=1e-5, atol=1e-5)
    assert runs["graphed"] == runs["eager"] and runs["eager"].get("render", 0) > 0
    assert launches["graphed"] == launches["eager"] >= 9 * 29  # every SO3 and GN iteration


def test_engine_logs_distinct_rows_through_the_graph(cuda):
    """The engine on the card captures one graph for its camera and replays
    it: ten logged stats rows, each its own tensor with its own frame's
    pose (none aliases the graph's buffer), ten replays, no state copied
    in; the history and the state's pose agree with the last row."""
    from densemonoslam_tpu_torch import step as tstep
    from densemonoslam_tpu_torch.utils import graphs

    seq, intr, cfg, frames = _graph_case(cuda)
    eng = Engine(seq.camera, cfg, device=cuda)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    for k, (rgb, depth) in enumerate(frames):
        eng.process_frame("cam0", rgb, depth, float(k), sync=False)
    copies = graphs.STATE_COPIES
    torch.cuda.synchronize()
    assert graphs.CAPTURES - captures == 1 and graphs.REPLAYS - replays == len(frames)
    assert len({r.data_ptr() for r in fe.stats_log}) == len(frames)
    rows = torch.stack(fe.stats_log).cpu().numpy()
    poses = rows[:, tstep.STAT_POSE0:]
    assert all(not np.array_equal(poses[i], poses[i + 1]) for i in range(len(poses) - 1)
               if rows[i + 1, tstep.STAT_TRACK_OK] == 1)
    np.testing.assert_array_equal(fe.pose.reshape(-1), poses[-1])
    np.testing.assert_array_equal(fe.pose_hist[: len(frames)].cpu().numpy().reshape(len(frames), 16),
                                  poses)
    eng.process_frame("cam0", *frames[0], float(len(frames)), sync=False)
    assert graphs.STATE_COPIES == copies  # steady state: nothing copied in


def test_graphed_optimise_matches_eager(cuda):
    """GN-CG as one graph against the eager `optimise` on one problem, then
    replayed on a second problem of the same shape (new inputs copied into
    the graph): node parameters within 1e-5, the three stats within rtol
    1e-5; one capture for both calls."""
    from densemonoslam_tpu_torch.utils import graphs

    rng = np.random.default_rng(3)
    K, C, R = 64, 60, 8
    t = np.sort(rng.uniform(0, 60, K)).astype(np.float32)
    g = tdg.DeformGraph(
        pos=torch.from_numpy(rng.uniform(-2, 2, (K, 3)).astype(np.float32)).to(cuda),
        time=torch.from_numpy(t).to(cuda), valid=torch.ones(K, dtype=torch.bool, device=cuda),
        A=torch.eye(3, device=cuda).repeat(K, 1, 1), t=torch.zeros(K, 3, device=cuda),
    )
    captures = graphs.CAPTURES
    for shift in (0.05, 0.03):
        src = rng.uniform(-2, 2, (C, 3)).astype(np.float32)
        dst = src + np.array([0.0, shift, 0.02], np.float32)
        cons = tdg.Constraint(
            src=torch.from_numpy(src).to(cuda), dst=torch.from_numpy(dst).to(cuda),
            time=torch.from_numpy(np.floor(rng.uniform(20, 60, C)).astype(np.float32)).to(cuda),
            valid=torch.from_numpy(rng.random(C) > 0.1).to(cuda),
            pinned=torch.zeros(C, dtype=torch.bool, device=cuda),
        )
        rsrc = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
        rel = tdg.RelConstraint(
            src=torch.from_numpy(rsrc).to(cuda), dst=torch.from_numpy(rsrc + 0.01).to(cuda),
            src_time=torch.full((R,), 40.0, device=cuda), dst_time=torch.full((R,), 10.0, device=cuda),
            valid=torch.ones(R, dtype=torch.bool, device=cuda),
        )
        frozen = g.time < 20
        eg, es = tdg.optimise(g, cons, frozen=frozen, rel=rel)
        gg, gs = tdg.optimise_graphed(g, cons, frozen=frozen, rel=rel)
        torch.testing.assert_close(gg.A, eg.A, rtol=0, atol=1e-5)
        torch.testing.assert_close(gg.t, eg.t, rtol=0, atol=1e-5)
        for a, b in zip(gs, es):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert graphs.CAPTURES - captures == 1


def test_nested_branches_count_their_launches(cuda):
    """`graphs.branch` under capture: an IF node on the device flag, nested
    inside another; both sides leave the outputs right for every pair of
    flags, and the K1 launches inside the bodies count only for the
    replays in which they ran (settled from the device counters), also
    when the graph was dropped before the settle."""
    import gc

    from densemonoslam_tpu_torch.utils import graphs

    M = torch.randn(4800, 16, device=cuda)
    ref = tgram.gram(M)

    def program(a, b, x):
        y = x.clone()
        g = torch.zeros(16, 16, device=cuda)

        def outer():
            y.mul_(2.0)

            def inner():
                graphs.assign((g,), (tgram.gram(M),))

            graphs.branch(b, inner, "inner")

        graphs.branch(a, outer, "outer")
        return y, g

    fn = graphs.GraphedFn(program)
    x = torch.arange(4.0, device=cuda)
    fn(True, True, x)  # the capture
    torch.cuda.synchronize()
    graphs.settle_counts()
    before, runs = klaunches.total("gram"), dict(graphs.BRANCH_RUNS)
    for a, b in [(True, True), (True, False), (False, True), (False, False), (True, True)]:
        y, g = fn(a, b, x)
        assert torch.equal(y, x * 2 if a else x)
        assert torch.equal(g, ref if a and b else torch.zeros_like(ref))
    graphs.settle_counts()
    assert klaunches.total("gram") - before == 2
    assert graphs.BRANCH_RUNS["outer"] - runs.get("outer", 0) == 3
    assert graphs.BRANCH_RUNS["inner"] - runs.get("inner", 0) == 2
    fn(True, True, x)
    del fn
    gc.collect()
    graphs.settle_counts()
    assert klaunches.total("gram") - before == 3
    assert graphs.BRANCH_RUNS["inner"] - runs.get("inner", 0) == 3


def test_relocalisation_poll_waits_on_frame_t_minus_16(cuda, monkeypatch):
    """With relocalisation, the engine copies each frame's bad-frame count
    into pinned memory behind a CUDA event; the poll every 8 frames waits
    on the event of frame t-16 (frame 0's before there are 16), and on no
    other, where it read the row and waited for the whole stream.  The step
    is replaced by one that returns a stats row, as in the pacing test."""
    seq = SyntheticSequence(num_frames=2)
    rgb, depth = (torch.from_numpy(x).to(cuda) for x in seq.frame(0))
    cfg = EngineConfig(max_surfels=1 << 10, open_loop=True, relocalisation=True,
                       loop_check_interval=8)
    eng = Engine(seq.camera, cfg, device=cuda)
    fe = eng.frontend("cam0")
    fe.step_fn = lambda state, *a: (state, torch.zeros(29, device=cuda))
    waited = []
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda ev: waited.append(ev))
    made, polls = [], {}
    for i in range(33):
        n = len(waited)
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        made.append(fe.bad_counts[-1][0])
        polled = [ev for ev in waited[n:] if ev not in fe.frame_events]
        if polled:
            polls[fe.tick] = polled
    assert sorted(polls) == [8, 16, 24, 32]
    for tick, evs in polls.items():
        assert len(evs) == 1 and evs[0] is made[max(tick - 1 - 16, 0)]
    assert fe.consecutive_bad == 0 and not fe.lost


def test_graphed_step_stamps_its_stages(cuda):
    """The stage stamps captured into the step's graph and its IF bodies:
    per frame a start, a tracked and an end stamp, the render branch's two
    where it rendered and the fuse branch's two where it fused (the stats
    row's flag), each of them a replayed kernel launch; stage times that
    add up within the step's."""
    from densemonoslam_tpu_torch import step as tstep
    from densemonoslam_tpu_torch.utils import graphs

    seq, intr, cfg, frames = _graph_case(cuda)
    eng = Engine(seq.camera, cfg, device=cuda)
    fe = eng.frontend("cam0")
    fe.pose = seq.gt_pose(0).astype(np.float32)
    graphs.settle_counts()
    before = klaunches.total("stamp")
    for k, (rgb, depth) in enumerate(frames):
        eng.process_frame("cam0", rgb, depth, float(k), sync=False)
    torch.cuda.synchronize()
    graphs.settle_counts()
    st = eng.stage_ms("cam0")
    n = len(frames)
    fused = {k for k, row in enumerate(fe.stats_log) if float(row[tstep.STAT_FUSED]) > 0}
    rendered = {k for k, _ in st["render"]}
    assert [k for k, _ in st["track"]] == [k for k, _ in st["step"]] == list(range(n))
    assert {k for k, _ in st["fuse"]} == fused and fused <= rendered and 0 < len(fused) < n
    # the warm-up runs every body once, then each replay its own stamps
    assert klaunches.total("stamp") - before == 7 + 3 * n + 2 * (len(rendered) + len(fused))
    step = dict(st["step"])
    for stage in ("track", "render", "fuse"):
        for k, ms in st[stage]:
            assert 0.0 <= ms <= step[k]


def test_device_spans_time_the_card_and_refuse_a_capture(cuda):
    """A recorded device span's events time the work queued inside it; one
    opened while a graph captures raises."""
    from densemonoslam_tpu_torch.utils import timer

    a = torch.randn(2048, 2048, device=cuda)
    timer.reset()
    timer.enable()
    try:
        with timer.span("work", device=True):
            for _ in range(10):
                a = a @ a.T / 2048.0
        rec = timer.spans()[0]
        assert rec.events is not None and timer.device_ms(rec) > 0.0
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            with pytest.raises(RuntimeError, match="capture"):
                with torch.cuda.graph(g, stream=s):
                    with timer.span("captured", device=True):
                        a.add_(1.0)
    finally:
        timer.enable(False)
        timer.reset()
