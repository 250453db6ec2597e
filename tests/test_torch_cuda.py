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
    before = tgram.LAUNCHES
    out = tgram.gram(M)
    again = tgram.gram(M)
    padded = tgram.gram(torch.cat([M, torch.zeros(3000, C, device=cuda)]))
    torch.cuda.synchronize()
    assert tgram.LAUNCHES == before + 3
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
        before = tgram.LAUNCHES
        for i in range(8):
            info = eng.process_frame("cam0", *seq.frame(i), float(i))
            assert info["tracking_ok"] == 1.0
        launched = tgram.LAUNCHES - before
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
    before = tdeform.LAUNCHES
    out = tdeform.deform_map(d.clone(), c, graph)
    again = tdeform.deform_map(d.clone(), c, graph)
    ref = tdeform.deform_map_reference(d.clone(), c, graph)
    torch.cuda.synchronize()
    assert tdeform.LAUNCHES == before + 2
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
        launches = tdeform.LAUNCHES
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
                          tdeform.LAUNCHES - launches)
    assert runs["cuda"][0] is not None and runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][2] >= 1 and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][1][:, :3, 3], runs["cpu"][1][:, :3, 3], atol=1e-3)
