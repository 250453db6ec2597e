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


# ------------------------------------------ the fused tracking iteration (K1)

def _track_iter_inputs(**change):
    """A minimal valid SO3 call's arguments on the CPU, one of them changed."""
    from densemonoslam_tpu_torch.config import CameraIntrinsics
    from densemonoslam_tpu_torch.ops import track_iter

    args = dict(i_c=torch.zeros(60, 80), pack=torch.zeros(60, 80, 12),
                intr=CameraIntrinsics(66.0, 66.0, 39.5, 29.5),
                carry_in=torch.zeros(track_iter.SO3_CARRY),
                carry_out=torch.zeros(track_iter.SO3_CARRY))
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change",
    [
        {},  # every tensor on the CPU: no kernel there
        dict(i_c=torch.zeros(60, 80, dtype=torch.float64)),
        dict(pack=torch.zeros(80, 60, 12).transpose(0, 1)),  # not contiguous
        dict(pack=torch.zeros(60 * 80 * 12 + 1)[1:].view(60, 80, 12)),  # 4 bytes past 16
        dict(carry_out=torch.zeros(8)),  # too short for the carry
    ],
    ids=["cpu", "f64", "noncontig", "unaligned", "short_carry"],
)
def test_track_iteration_rejects_unsupported_input(change):
    """The fused iteration's wrapper raises `ValueError` on a tensor it cannot
    take (checked before anything is built or launched, so also here)."""
    from densemonoslam_tpu_torch.ops import track_iter

    before = launches.COUNTS.copy()
    with pytest.raises(ValueError):
        track_iter.so3_iteration(**_track_iter_inputs(**change), fresh=True)
    assert launches.COUNTS == before


@pytest.mark.parametrize(
    "n_c", [torch.zeros(30, 40, 3), torch.zeros(3, 60, 80).permute(1, 2, 0)],
    ids=["mismatched_grid", "strided_channels"],
)
def test_track_iteration_gn_rejects_maps_it_cannot_read(n_c):
    """A GN call whose normal map has another grid than the intensity, or
    channels that are not adjacent, raises (a row-strided view, which the
    kernel reads through its strides, is taken)."""
    from densemonoslam_tpu_torch.ops import track_iter

    a = _track_iter_inputs()
    with pytest.raises(ValueError):
        track_iter.gn_iteration(torch.zeros(60, 80, 3), n_c, a["i_c"], a["pack"], a["intr"],
                                torch.zeros(16), torch.zeros(track_iter.GN_CARRY), fresh=True,
                                bilinear=True, icp_weight=10.0, rgb_scale=1.0)


def test_track_iter_binding_matches_its_source():
    """The binding's mirror of `track_iter::Params` lists the source's fields
    in the source's order, with the source's types; the carry offsets and
    sizes are the source's."""
    import re

    from densemonoslam_tpu_torch.ops import cuda_build, track_iter

    src = (cuda_build.CSRC / "track_iter.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_types = {"const float*": "c_void_p", "float*": "c_void_p", "unsigned char*": "c_void_p",
               "unsigned*": "c_void_p", "long long": "c_longlong", "int": "c_int",
               "float": "c_float"}
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        typ = next(t for t in c_types if decl.startswith(t + " "))
        fields += [(name.strip(), c_types[typ]) for name in decl[len(typ):].split(",")]
    import ctypes

    assert [(n, getattr(ctypes, t)) for n, t in fields] == list(track_iter._Params._fields_)
    consts = dict(re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)", src))
    assert int(consts["C_ICP_ERR"]) == track_iter.ICP_ERR
    assert int(consts["C_RGB_INL"]) == track_iter.RGB_INL
    assert int(consts["C_JTJ"]) == track_iter.JTJ.start
    assert int(consts["C_DONE"]) == track_iter.DONE
    assert int(consts["GN_CARRY"]) == track_iter.GN_CARRY
    assert int(consts["S_RBEST"]) == track_iter.SO3_R_BEST.start
    assert int(consts["S_ERRBEST"]) == track_iter.SO3_ERR_BEST
    assert int(consts["S_DONE"]) == track_iter.SO3_DONE
    assert int(consts["SO3_CARRY"]) == track_iter.SO3_CARRY
    assert int(consts["GN_SAMPLE"]) == track_iter.GN_SAMPLE
    assert int(consts["SO3_SAMPLE"]) == track_iter.SO3_SAMPLE
    assert int(consts["SO3_SUMS"]) == track_iter.SO3_SUMS
    assert 2 * int(consts["GN_BLOCK"]) == track_iter.GN_SUMS
