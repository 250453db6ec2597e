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


# ------------------------------------------- the fused tracking iteration (K1)

def _track_case(W, H, levels=4, f0=5, f1=6):
    """Frame f1 tracked against frame f0's pyramid on the revisit orbit with
    a W x H camera (fx = fy = 528 W / 640), warm start ~1 cm / ~0.6 deg off
    the true motion: (model, frame, intrinsics, A0), CPU tensors."""
    from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution
    from densemonoslam_tpu_torch.tracking import odometry as todo
    from densemonoslam_tpu_torch.utils import se3

    intr = CameraIntrinsics(528.0 * W / 640, 528.0 * W / 640, W / 2 - 0.5, H / 2 - 0.5)
    seq = SyntheticSequence(camera=CameraConfig(FrameResolution(W, H), intr, "track"),
                            num_frames=40, radius=0.35, max_angle=0.3)
    (rgb_m, d_m), (rgb_c, d_c) = seq.frame(f0), seq.frame(f1)
    rel = np.linalg.inv(seq.gt_pose(f0)) @ seq.gt_pose(f1)
    off = se3.se3_exp(torch.tensor([0.01, 0.0, -0.005, 0.01, -0.005, 0.0])).numpy()
    A0 = torch.from_numpy((off @ rel).astype(np.float32))
    model = todo.model_pyramid_from_frame(todo.build_frame_pyramid(
        torch.from_numpy(rgb_m), torch.from_numpy(d_m), intr, levels))
    frame = todo.build_frame_pyramid(torch.from_numpy(rgb_c), torch.from_numpy(d_c), intr, levels)
    return model, frame, intr, A0


def _to(tree, dev):
    return type(tree)(*(tuple(x.to(dev) for x in field) for field in tree))


def _level(model, frame, intr, lv, bilinear, rgb_only, dev, stride=2):
    """`odometry._gn_level`'s `_Level` of pyramid level `lv` on `dev`."""
    from densemonoslam_tpu_torch.ops import warp
    from densemonoslam_tpu_torch.tracking import odometry as todo

    v, n, i = frame.vmap[lv], frame.nmap[lv], frame.intensity[lv]
    if i.numel() // (stride * stride) >= 4096:
        v, n, i = (warp.decimate(x, stride) for x in (v, n, i))
    return todo._Level(v_c=v.to(dev), n_c=n.to(dev), i_c=i.to(dev), pack_m=model.pack[lv].to(dev),
                       intr=intr.scaled(lv), bilinear=bilinear,
                       icp_weight=0.0 if rgb_only else 10.0)


def _gn_carry(c, dev):
    """A plain carry (A, stats, done) in the fused kernel's layout."""
    A, (e_i, n_i, e_r, n_r, JtJ), done = c
    out = torch.zeros(64)
    out[:16] = A.reshape(16)
    out[16:20] = torch.stack([e_i, n_i, e_r, n_r])
    out[20:56] = JtJ.reshape(36)
    out[56] = float(done)
    return out.to(dev)


def _assert_stats_close(fused, plain, what, count_slack):
    """One 8-column block's sums against `gram_reference` of the plain rows.
    Counts within `count_slack` rows: a row whose gate value lies within an
    ulp of its threshold may round to the other side when a sum of three
    products is taken in another order.  JtJ within 5e-4 of the block's
    largest entry, Jtr and sum r^2 within 5e-5 of theirs: f32 sums of up
    to 82k products (magnitudes 1e-6..1e6) in the kernel's block order
    against BLAS's; a sequential sum, the worst order, reads 1.7e-4."""
    assert abs(float(fused.inliers) - float(plain.inliers)) <= count_slack, what
    for name, rtol in (("JtJ", 5e-4), ("Jtr", 5e-5), ("residual_sq", 5e-5)):
        a, b = getattr(fused, name).cpu().double(), getattr(plain, name).double()
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= rtol * scale, (what, name)


def _assert_carry_close(fused, plain, what, count_slack):
    """The carry after an iteration: the pose within 1e-5 (one f32 GN step
    from the same sums, rounded in another order: 1e-6 in a host emulation),
    the errors within 1e-4 relative, the inlier counts as in
    `_assert_stats_close`, JtJ within 5e-4 of its largest entry, `done`
    exactly."""
    fused = fused.cpu()
    A, (e_i, n_i, e_r, n_r, JtJ), done = plain
    np.testing.assert_allclose(fused[:16].numpy(), A.reshape(16).numpy(), atol=1e-5, err_msg=what)
    for k, e in ((16, e_i), (18, e_r)):
        np.testing.assert_allclose(float(fused[k]), float(e), rtol=1e-4, err_msg=what)
    for k, n in ((17, n_i), (19, n_r)):
        assert abs(float(fused[k]) - float(n)) <= count_slack, what
    scale = float(JtJ.abs().max())
    assert float((fused[20:56] - JtJ.reshape(36)).abs().max()) <= 5e-4 * scale, what
    assert bool(fused[56] != 0) == bool(done), what


# (W, H, level, bilinear, rgb_only): the main paths' GN shapes, revisit
# 76800, 19200 and 4800 rows (levels 0-2 at row stride 2; level 3 is 4800
# rows too, unstrided) and mono's 81920 (its level 0)
GN_CASES = [(640, 480, 0, False, False), (640, 480, 1, False, False), (640, 480, 2, True, False),
            (640, 480, 3, True, True), (1024, 320, 0, False, False)]


@pytest.mark.parametrize("W,H,lv,bilinear,rgb_only", GN_CASES,
                         ids=["revisit_76800", "revisit_19200", "revisit_4800",
                              "revisit_4800_rgb_only", "mono_81920"])
def test_track_iteration_matches_plain(cuda, W, H, lv, bilinear, rgb_only):
    """One fused GN iteration against the plain composition (the
    `reductions` rows, `gram_reference`, `solve_se3`, `_advance`, on the
    CPU) from the same carry: exact, the first frozen iteration (which
    samples and keeps the carry it started from) and a frozen one that
    reads the sample; the G blocks, the carry's pose, stats and `done`, and
    the starvation flag."""
    from densemonoslam_tpu_torch.ops import reductions as tred
    from densemonoslam_tpu_torch.ops import track_iter as ti
    from densemonoslam_tpu_torch.tracking import odometry as todo

    model, frame, intr, A0 = _track_case(W, H)
    cpu = _level(model, frame, intr, lv, bilinear, rgb_only, "cpu")
    dev = _level(model, frame, intr, lv, bilinear, rgb_only, cuda)
    P = cpu.i_c.numel()
    slack = 2 + 5e-4 * P
    inf, zero = torch.full((), float("inf")), torch.zeros(())
    c0 = (A0, (inf, zero, inf, zero, torch.eye(6)), torch.zeros((), dtype=torch.bool))
    c1 = todo._exact_iters(cpu, c0, 1)
    c2, first_ok = todo._frozen_iters(cpu, c1, 1)
    c3, _ = todo._frozen_iters(cpu, c1, 2)
    # the plain rows of each iteration, at the plain carry it started from
    v, n, i = (x.reshape(P, -1).squeeze(-1) for x in (cpu.v_c, cpu.n_c, cpu.i_c))
    rows0 = tred.joint_rows_packed(cpu.v_c, cpu.n_c, cpu.i_c, cpu.pack_m, c0[0], cpu.intr,
                                   bilinear=bilinear)
    rows1 = tred.joint_rows_packed(cpu.v_c, cpu.n_c, cpu.i_c, cpu.pack_m, c1[0], cpu.intr,
                                   bilinear=bilinear)
    u0, v0, _ = todo.geometry.project(todo.se3.transform_points(c1[0], v), cpu.intr)
    smp = tred.sample_model(cpu.pack_m, u0, v0, bilinear=bilinear)
    rows2 = tred.joint_rows_frozen(v, n, i, smp, torch.stack([u0, v0], -1), c2[0], cpu.intr)

    carry = torch.empty(64, device=cuda)
    sample = torch.empty(P * ti.GN_SAMPLE, device=cuda)
    pre = torch.empty(64, device=cuda)
    starved = torch.ones((), dtype=torch.bool, device=cuda)
    kw = dict(bilinear=bilinear, icp_weight=dev.icp_weight, rgb_scale=todo.RGB_UNIT_SCALE)
    steps = [
        (A0.to(cuda), True, {}, rows0, c1),
        (_gn_carry(c1, cuda), False, dict(sample=sample, write_sample=True, pre=pre,
                                          starved=starved), rows1, c2),
        (_gn_carry(c2, cuda), False, dict(sample=sample), rows2, c3),
    ]
    before = dict(klaunches.by_shape("track_iter"))
    for k, (src, fresh, extra, (Mi, Mr), want) in enumerate(steps):
        sums = ti.gn_iteration(dev.v_c, dev.n_c, dev.i_c, dev.pack_m, dev.intr, src, carry,
                               fresh=fresh, **kw, **extra)
        torch.cuda.synchronize()
        G = tgram.gram_reference(torch.cat([Mi, Mr], dim=-1))
        got = ti.unpack_sums(sums)
        _assert_stats_close(got[0], tred.unpack_gram(G[:8, :8]), f"iteration {k} ICP", 2)
        _assert_stats_close(got[1], tred.unpack_gram(G[8:, 8:]), f"iteration {k} RGB", 2)
        _assert_carry_close(carry, want, f"iteration {k}", slack)
    _assert_carry_close(pre, c1, "carry before the first frozen iteration", 0)
    assert bool(starved) == bool(~c1[2] & ~first_ok)
    after = klaunches.by_shape("track_iter")
    assert after["gn_exact"] - before.get("gn_exact", 0) == 1
    assert after["gn_frozen"] - before.get("gn_frozen", 0) == 2


def _so3_plain(R, R_best, err_best, done, M):
    """One iteration of `odometry._so3_prealign` on the rows M (plain)."""
    from densemonoslam_tpu_torch.ops import reductions as tred
    from densemonoslam_tpu_torch.utils import se3

    G = tgram.gram_reference(M)
    err = G[3, 3] / torch.clamp(G[7, 7], min=1.0)
    dw = tred.solve_so3(G[:3, :3], G[:3, 3], damping=1e-4)
    ok = (G[7, 7] > 50) & torch.all(torch.isfinite(dw))
    R_new = torch.where(ok, se3.so3_exp(dw) @ R, R)
    improved = err < err_best
    R_best_new = torch.where(improved, R, R_best)
    err_best_new = torch.minimum(err, err_best)
    R_next = torch.where(improved, R_new, R_best_new)
    step_done = ~ok | (torch.sum(dw * dw) < 1e-10)
    return (torch.where(done, R, R_next), torch.where(done, R_best, R_best_new),
            torch.where(done, err_best, err_best_new), done | step_done, G)


def test_so3_iteration_matches_plain(cuda):
    """The SO3 pre-align at revisit's coarsest level (4800 rows x 8): each
    of its ten fused iterations (3 exact, the sampling one, 6 frozen) from
    the plain carry against the plain iteration (`so3_rows_packed` /
    `so3_rows_frozen`, `gram_reference`, `solve_so3`, the rollback); then
    the whole fused pre-align against `_so3_prealign` on the CPU.  The same
    tolerances as the GN iterations (rotation within 1e-5)."""
    from densemonoslam_tpu_torch.ops import reductions as tred
    from densemonoslam_tpu_torch.ops import track_iter as ti
    from densemonoslam_tpu_torch.tracking import odometry as todo

    model, frame, intr, A0 = _track_case(640, 480)
    lv = 3
    it = intr.scaled(lv)
    i_c, pack = frame.intensity[lv], model.pack[lv]
    H, W = i_c.shape
    d = tred.unit_rays(H, W, it, "cpu")
    R, R_best = A0[:3, :3], A0[:3, :3]
    err_best, done = torch.full((), float("inf")), torch.zeros((), dtype=torch.bool)
    carry = torch.empty(ti.SO3_CARRY, device=cuda)
    sample = torch.empty(H * W * ti.SO3_SAMPLE, device=cuda)
    smp = uv0 = None
    for k in range(todo.SO3_ITERATIONS):
        if k == 3:
            u0, v0, _ = todo.geometry.project(torch.sum(R * d[:, None, :], dim=-1), it)
            smp, uv0 = tred.sample_model(pack, u0, v0), torch.stack([u0, v0], -1)
        M = (tred.so3_rows_packed(i_c, pack, R, it) if k < 3
             else tred.so3_rows_frozen(d, i_c.reshape(-1), smp, uv0, R, it))
        src = A0.clone()
        src[:3, :3] = R
        src = torch.cat([src.reshape(16), R_best.reshape(9), err_best.reshape(1),
                         done.to(torch.float32).reshape(1), torch.zeros(5)]).to(cuda)
        sums = ti.so3_iteration(i_c.to(cuda), pack.to(cuda), it, src, carry, fresh=k == 0,
                                sample=sample if k >= 3 else None, write_sample=k == 3)
        R, R_best, err_best, done, G = _so3_plain(R, R_best, err_best, done, M)
        (got,) = ti.unpack_sums(sums.cpu())
        JtJ, Jtr = G[:3, :3], G[:3, 3]
        assert abs(float(got.inliers) - float(G[7, 7])) <= 2, k
        for a, b, rtol in ((got.JtJ, JtJ, 5e-4), (got.Jtr, Jtr, 5e-5),
                           (got.residual_sq, G[3, 3], 5e-5)):
            assert float((a - b).abs().max()) <= rtol * float(b.abs().max()), k
        out = carry.cpu()
        np.testing.assert_allclose(out[:16].view(4, 4)[:3, :3].numpy(), R.numpy(), atol=1e-5)
        np.testing.assert_allclose(out[16:25].numpy(), R_best.reshape(9).numpy(), atol=1e-5)
        np.testing.assert_allclose(float(out[25]), float(err_best), rtol=1e-4)
        assert bool(out[26] != 0) == bool(done), k
        np.testing.assert_array_equal(out[:16].view(4, 4)[:3, 3].numpy(), A0[:3, 3].numpy())
    whole = todo._so3_prealign_fused(_to(model, cuda), _to(frame, cuda), it, A0.to(cuda))
    np.testing.assert_allclose(whole[:3, :3].cpu().numpy(),
                               todo._so3_prealign(model, frame, it, A0[:3, :3]).numpy(), atol=1e-5)


def test_track_iteration_is_bit_identical(cuda):
    """Two eager runs of an exact, a sampling and a frozen iteration give the
    same bits, and so does a CUDA graph of the three, replayed twice."""
    from densemonoslam_tpu_torch.ops import track_iter as ti
    from densemonoslam_tpu_torch.tracking import odometry as todo

    model, frame, intr, A0 = _track_case(640, 480)
    lvl = _level(model, frame, intr, 0, False, False, cuda)
    A0 = A0.to(cuda)

    def three():
        carry = torch.empty(64, device=cuda)
        sample = torch.empty(lvl.i_c.numel() * ti.GN_SAMPLE, device=cuda)
        kw = dict(bilinear=False, icp_weight=10.0, rgb_scale=todo.RGB_UNIT_SCALE)
        args = (lvl.v_c, lvl.n_c, lvl.i_c, lvl.pack_m, lvl.intr)
        s = [ti.gn_iteration(*args, A0, carry, fresh=True, **kw),
             ti.gn_iteration(*args, carry, carry, fresh=False, sample=sample, write_sample=True,
                             **kw),
             ti.gn_iteration(*args, carry, carry, fresh=False, sample=sample, **kw)]
        return torch.cat([carry, *s])

    eager = [three(), three()]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        three()  # the capture stream's scratch exists before the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = three()
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    assert torch.equal(eager[0], eager[1])
    assert all(torch.equal(r, eager[0]) for r in replays)


@pytest.mark.parametrize("W,H", [(640, 480), (1024, 320)])
def test_track_on_card_matches_cpu(cuda, W, H):
    """A whole `odometry.track` at the cells' settings (4 levels, iterations
    (4, 5, 10, 10), row stride 2, SO3 on) on the card against the CPU's plain
    path: the pose within 1e-4 m and 1e-4 rad (two f32 runs of 39
    iterations, `tests/test_torch_tracking.py`'s tolerance), inliers within
    0.1%; every iteration one fused launch (39, by mode), counted under K1
    at its shapes, and at most 60 device operations in the call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from densemonoslam_tpu_torch.tracking import odometry as todo

    model, frame, intr, A0 = _track_case(W, H)
    kw = dict(iterations=(4, 5, 10, 10), icp_weight=10.0, row_stride=2)
    ref = todo.track(model, frame, A0, intr, **kw)
    m, f, a = _to(model, cuda), _to(frame, cuda), A0.to(cuda)
    todo.track(m, f, a, intr, **kw)  # builds the kernel
    torch.cuda.synchronize()

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # views, allocations, the branch's host read and profiler
            # ranges launch nothing
            skip = (func.is_view or func.namespace == "profiler"
                    or func in (torch.ops.aten.empty.memory_format,
                                torch.ops.aten._local_scalar_dense.default))
            Ops.n += 0 if skip else 1
            return func(*args, **(kwargs or {}))

    before = klaunches.COUNTS.copy()
    with Ops():
        res = todo.track(m, f, a, intr, **kw)
    torch.cuda.synchronize()
    delta = klaunches.COUNTS.copy()
    delta.subtract(before)
    modes = {s: n for (k, s), n in delta.items() if k == "track_iter" and n}
    assert modes == {"gn_exact": 2, "gn_frozen": 27, "so3_exact": 3, "so3_frozen": 7}
    assert sum(n for (k, _), n in delta.items() if k == "gram") == 39
    assert Ops.n + 39 <= 60, Ops.n
    assert not bool(res.failed) and not bool(ref.failed)
    dT = np.linalg.inv(ref.A.numpy()) @ res.A.cpu().numpy()
    assert np.linalg.norm(dT[:3, 3]) < 1e-4
    assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-4
    for name in ("icp_inliers", "rgb_inliers"):
        a_, b_ = float(getattr(res, name)), float(getattr(ref, name))
        assert abs(a_ - b_) <= 1e-3 * b_, name


def test_track_iteration_rejects_bad_input_on_cuda(cuda):
    """The wrapper raises on a card tensor of the wrong dtype, a pack that is
    not contiguous or not 16-byte aligned, and a tensor left on the CPU."""
    from densemonoslam_tpu_torch.config import CameraIntrinsics
    from densemonoslam_tpu_torch.ops import track_iter as ti

    intr = CameraIntrinsics(66.0, 66.0, 39.5, 29.5)
    i_c, pack = torch.zeros(60, 80, device=cuda), torch.zeros(60, 80, 12, device=cuda)
    carry = torch.zeros(ti.SO3_CARRY, device=cuda)
    bad = [(i_c.double(), pack, carry), (i_c, pack.transpose(0, 1), carry),
           (i_c, torch.zeros(60 * 80 * 12 + 1, device=cuda)[1:].view(60, 80, 12), carry),
           (i_c, pack, carry.cpu())]
    for a, b, c in bad:
        with pytest.raises(ValueError):
            ti.so3_iteration(a, b, intr, c, carry, fresh=True)


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
