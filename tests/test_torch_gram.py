"""Kernel K1 (Gram reduction) of the PyTorch port against the Pallas kernel
it replaces, run in interpret mode as `tests/test_pallas.py` runs it.

Tolerance rtol 2e-5 / atol 1e-2, the one `tests/test_pallas.py` uses: f32
sums over up to 10^4 rows of N(0,1) products taken in different orders."""

import numpy as np
import pytest
import torch

from densemonoslam_tpu.ops.pallas.gram import gram_pallas
from densemonoslam_tpu_torch.ops import gram as tgram
from densemonoslam_tpu_torch.utils import launches

torch.set_num_threads(2)


@pytest.mark.parametrize("P,C", [(4096, 8), (10000, 8), (100, 16), (4800, 16)])
def test_gram_reference_matches_pallas(rng, P, C):
    M = rng.normal(0, 1, (P, C)).astype(np.float32)
    ref = np.asarray(gram_pallas(M, interpret=True))
    out = tgram.gram(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-2)


def test_gram_zero_pad_invariance(rng):
    """Zero rows (masked-out residuals) must not change the result.  On the
    CPU the plain version goes through BLAS, whose blocking (and so its
    summation order) follows P, hence the Gram tolerance rather than
    equality; `tests/test_torch_cuda.py` requires bit equality of the kernel."""
    M = torch.from_numpy(rng.normal(0, 1, (5000, 8)).astype(np.float32))
    out1 = tgram.gram(M)
    out2 = tgram.gram(torch.cat([M, torch.zeros(3000, 8)]))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize(
    "M",
    [
        torch.zeros(64, 8, dtype=torch.float64),  # dtype
        torch.zeros(64, 12),  # unsupported width
        torch.zeros(8, 64).T,  # not contiguous
        torch.zeros(4, 16, 16),  # not 2-D
    ],
    ids=["f64", "C12", "noncontig", "3d"],
)
def test_gram_rejects_unsupported_input(M):
    with pytest.raises(ValueError):
        tgram.gram(M)


def test_gram_cpu_path_launches_no_kernel(rng):
    """On a CPU tensor the wrapper takes the plain version and counts no
    launch (the count is the proof that a GPU run used the kernel)."""
    before = launches.total("gram")
    tgram.gram(torch.from_numpy(rng.normal(0, 1, (300, 16)).astype(np.float32)))
    assert launches.total("gram") == before
