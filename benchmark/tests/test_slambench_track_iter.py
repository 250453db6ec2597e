"""`metrics/track_iter_roofline_pct.py` on made-up counts and traces: the
share from hand counts, nothing read from a program without the fused
iteration or where the counts and the trace disagree, and the kernel name
it looks for present in the fused kernel's source."""

from __future__ import annotations

import collections
import importlib.util
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _reader():
    path = BENCH / "metrics" / "track_iter_roofline_pct.py"
    spec = importlib.util.spec_from_file_location("track_iter_roofline_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Trace:
    def __init__(self, ops):
        self.ops = ops  # (name, start, end)

    def kernels(self, names):
        return [(s, e) for n, s, e in self.ops if any(k in n for k in names)]


class _Ctx:
    def __init__(self, launches, ops):
        self.launches = collections.Counter(launches)
        self.trace = _Trace(ops)


def _step(t0):
    """One step's 39 launches, 10 us apart and 5 us each, at revisit's shapes."""
    name = "void track_iter::track_iter_gram_kernel<true>(track_iter::Params)"
    return [(name, t0 + 1e-5 * k, t0 + 1e-5 * k + 5e-6) for k in range(39)]


STEP = {("gram", (4800, 8)): 10, ("gram", (4800, 16)): 20, ("gram", (19200, 16)): 5,
        ("gram", (76800, 16)): 4, ("track_iter", "so3_exact"): 3,
        ("track_iter", "so3_frozen"): 7, ("track_iter", "gn_exact"): 2,
        ("track_iter", "gn_frozen"): 27}


def test_share_from_hand_counts():
    mod = _reader()
    rows_bytes = 10 * 4800 * 36 + (20 * 4800 + 5 * 19200 + 4 * 76800) * 76
    want = 100.0 * (rows_bytes / 3.35e12) / (39 * 5e-6)
    assert mod.read(_Ctx(STEP, _step(0.0))) == pytest.approx(want, rel=1e-9)
    assert mod.read(_Ctx({k: 2 * n for k, n in STEP.items()}, _step(0.0) + _step(1.0))) \
        == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("case", ["unfused program", "count off", "no trace"])
def test_nothing_read_where_nothing_matches(case):
    mod = _reader()
    if case == "unfused program":
        # the program before the fused iteration: gram(M) alone, its own kernel name
        launches = {k: n for k, n in STEP.items() if k[0] == "gram"}
        ops = [("void gram_kernel<16>(float const*)", 1e-5 * k, 1e-5 * k + 5e-6)
               for k in range(39)]
        ctx = _Ctx(launches, ops)
    elif case == "count off":
        ctx = _Ctx(STEP, _step(0.0)[:-1])
    else:
        ctx = _Ctx(STEP, [])
        ctx.trace = None
    assert mod.read(ctx) is None


def test_kernel_name_is_the_fused_kernels():
    src = (ROOT / "densemonoslam_tpu_torch" / "csrc" / "track_iter.cu").read_text()
    (name,) = _reader().KERNEL_NAMES
    assert f" {name}(" in src
    # K1's own reader keeps finding the fused kernel under its name
    k1 = (BENCH / "metrics" / "k1_roofline_pct.py").read_text()
    assert 'KERNEL_NAMES = ("gram_kernel",)' in k1 and "gram_kernel" in name
