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


def test_gram_kernel_rejects_bad_input_on_cuda(cuda):
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(64, 12, device=cuda))
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(64, 8, device=cuda, dtype=torch.float16))


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
