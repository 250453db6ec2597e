"""Kernel K3, the render of the whole surfel map (`csrc/zbuffer.cu` via
`ops/zbuffer.py`), and its dispatch from `splat.render`.

The CPU cases hold the dispatch rule (only an unwindowed render of more than
1<<21 rows on the card goes to K3; the CPU keeps the op-by-op path), the
wrapper's rejections and its launch count.  The `cuda` cases hold K3 to the
op-by-op exact path (`splat.render_ops`) on the card, winner for winner.
This file imports no jax, so its card cases run where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_zbuffer.py
"""

import ctypes
import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import cuda_build, splat, zbuffer
from densemonoslam_tpu_torch.utils import launches, timer

torch.set_num_threads(2)

W, H = 640, 480
INTR = CameraIntrinsics(528.0, 528.0, 319.5, 239.5)
FULL = splat.PACKED_MAX_ROWS + 4096  # more rows than the packed key holds
T_NOW, TIME_DELTA = 100.0, 30
MODES = {"active": splat.MODE_ACTIVE, "inactive": splat.MODE_INACTIVE, "all": splat.MODE_ALL}


def _pose() -> np.ndarray:
    """A camera-to-world pose off every axis."""
    a, b = 0.3, -0.2
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Rx
    T[:3, 3] = (0.4, -0.3, 1.1)
    return T.astype(np.float32)


def _surfels(g, n: int, z_lo: float, z_hi: float, pose: np.ndarray) -> np.ndarray:
    """`n` rows of surfels at depths in [z_lo, z_hi) seen from `pose` (a
    twentieth behind the camera, a margin outside the image), random
    confidence (some dead), colour, radius, a normal towards the camera and
    last-seen times on either side of the time window."""
    rows = np.zeros((n, 16), np.float32)
    z = g.uniform(z_lo, z_hi, n)
    z[g.random(n) < 0.05] *= -1.0
    u, v = g.uniform(-30, W + 30, n), g.uniform(-30, H + 30, n)
    p_cam = np.stack([(u - INTR.cx) / INTR.fx * z, (v - INTR.cy) / INTR.fy * z, z], -1)
    n_cam = np.stack([g.normal(0, 0.3, n), g.normal(0, 0.3, n), -np.ones(n)], -1)
    n_cam /= np.linalg.norm(n_cam, axis=-1, keepdims=True)
    R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    rows[:, 0:3] = p_cam @ R.T + t
    rows[:, 3] = g.uniform(-1.0, 10.0, n)
    rows[:, 4:7] = g.uniform(0, 255, (n, 3))
    rows[:, 7] = g.uniform(0.002, 0.03, n)
    rows[:, 8:11] = n_cam @ R.T
    rows[:, 12] = g.uniform(0, T_NOW, n)
    rows[:, 13] = np.where(g.random(n) < 0.2, g.uniform(0, T_NOW, n), 0.0)
    return rows


def _map(n_cap: int, seed: int):
    """(data [n_cap + 1, 16], count, tie pairs) of a map whose rows below
    `count` are surfels 0.3-6 m from `_pose()`, with a 32nd of them copied
    to a later row in another colour (equal z, equal cell: the lower row
    must win), and whose rows from `count` on, the dump row included, are
    live-looking surfels nearer than any of them, in every mode's time
    window: a render that read one would show it."""
    g = np.random.default_rng(seed)
    pose = _pose()
    count = n_cap - 3000
    data = np.concatenate([_surfels(g, count, 0.3, 6.0, pose),
                           _surfels(g, n_cap + 1 - count, 0.06, 0.29, pose)])
    data[count:, 3] = 5.0
    data[count:, 12] = np.where(np.arange(n_cap + 1 - count) % 2, T_NOW, 0.0)
    half, m = count // 2, count // 32
    lo = g.choice(half, m, replace=False)
    hi = half + g.choice(count - half, m, replace=False)
    data[hi] = data[lo]
    data[hi, 4:7] = 255.0 - data[lo, 4:7]
    return data, count, np.stack([lo, hi], -1)


class _StubLaunch:
    """Stands in for the library's launch on the CPU: records each call's
    Params and launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, prm, device, stream):
        p = prm._obj
        self.calls.append({name: getattr(p, name) for name, _ in p._fields_})
        return 0


@pytest.fixture
def on_cpu_card(monkeypatch):
    """K3's wrapper taking CPU tensors for its kernel device, its library
    replaced by `_StubLaunch`: the dispatch and the count without a card."""
    stub = _StubLaunch()
    monkeypatch.setattr(zbuffer, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(zbuffer, "_load", lambda: stub)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    return stub


def _render(data, count, mode, **kw):
    return splat.render(data, torch.tensor(count, device=data.device),
                        torch.from_numpy(_pose()).to(data.device),
                        INTR, W, H, T_NOW, time_delta=TIME_DELTA, mode=mode, **kw)


@pytest.mark.parametrize(
    "n_rows,windowed,full",
    [(1 << 12, False, False), (splat.PACKED_MAX_ROWS, False, False),
     (splat.PACKED_MAX_ROWS + 1, False, True), (1 << 25, False, True), (1 << 25, True, False)],
    ids=["small", "packed_limit", "one_over", "capacity", "windowed"],
)
def test_full_map_rule(n_rows, windowed, full):
    """A render is of the whole map, K3's on the card, exactly where it has
    no window and the packed key cannot hold its rows (`packed_key_params`
    gives None at every depth range)."""
    assert splat.full_map(n_rows, windowed) is full
    if full:
        assert splat.packed_key_params(n_rows, 100.0, windowed) is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_full_render_is_one_launch(on_cpu_card, mode):
    """With K3's kernel device made the CPU and its library stubbed, a render
    of the whole map is one launch, counted under ("zbuffer", mode), with
    the render's arguments in its Params and the prediction's shapes."""
    data = torch.zeros(FULL + 1, 16)
    before = launches.COUNTS.copy()
    pred = _render(data, FULL - 10, MODES[mode], splat_k=5, depth_max=8.0)
    assert launches.COUNTS - before == {("zbuffer", mode): 1}
    (prm,) = on_cpu_card.calls
    assert (prm["n_rows"], prm["width"], prm["height"], prm["mode"], prm["half"]) == (
        FULL, W, H, MODES[mode], 2)
    assert prm["inv_fx"] == np.float32(1.0) / np.float32(INTR.fx)
    assert (prm["depth_max"], prm["time_delta"], prm["r_max"]) == (8.0, TIME_DELTA, 3.75)
    for name, t in pred._asdict().items():
        assert t.shape[:2] == (H, W), name
        assert t.dtype == (torch.int64 if name in ("index", "cell") else torch.float32), name
        assert prm[name if name != "time" else "time_out"] == t.data_ptr(), name


@pytest.mark.parametrize(
    "n_rows,kw",
    [(FULL, dict(mode=splat.MODE_ACTIVE, window=4096)),
     (1 << 12, dict(mode=splat.MODE_INACTIVE)),
     (1 << 12, dict(mode=splat.MODE_ALL, packed_zbuffer=False))],
    ids=["windowed", "small_inactive", "small_exact"],
)
def test_other_renders_launch_nothing(on_cpu_card, n_rows, kw):
    """A windowed render, and any render of at most 1<<21 rows (the packed
    path, or the exact one where asked), keeps the op-by-op path even where
    K3 could run."""
    data, count, _ = _map(n_rows, seed=3)
    before = launches.COUNTS.copy()
    pred = _render(torch.from_numpy(data), count, **kw)
    assert launches.COUNTS == before and not on_cpu_card.calls
    assert bool((pred.index >= 0).any())


def test_cpu_full_render_keeps_the_op_path(monkeypatch):
    """On the CPU a render of the whole map is the op-by-op path inside a
    host `render.full` span, launching nothing; no row at or above the
    count wins."""
    def refuse(*a, **k):
        raise AssertionError("K3 called on the CPU")

    monkeypatch.setattr(zbuffer, "render_full", refuse)
    data, count, _ = _map(FULL, seed=5)
    data = torch.from_numpy(data)
    before = launches.COUNTS.copy()
    timer.reset()
    timer.enable()
    try:
        pred = _render(data, count, splat.MODE_INACTIVE)
        recs = [r for r in timer.spans() if r.name == "render.full"]
    finally:
        timer.enable(False)
        timer.reset()
    assert launches.COUNTS == before
    assert len(recs) == 1 and recs[0].events is None
    assert 0 < int((pred.cell >= 0).sum()) and int(pred.cell.max()) < count
    assert int(pred.index.max()) < count


def _valid_args(**change):
    """A valid call of `render_full` on CPU tensors, one argument changed."""
    args = dict(data=torch.zeros(1025, 16), count=torch.tensor(1000), tinv=torch.eye(4),
                t_now=torch.tensor(T_NOW), intr=INTR, width=W, height=H,
                time_delta=TIME_DELTA, mode=splat.MODE_INACTIVE, splat_k=3, depth_max=8.0)
    args.update(change)
    return args


_BAD = {
    "f64_data": dict(data=torch.zeros(1025, 16, dtype=torch.float64)),
    "narrow_data": dict(data=torch.zeros(1025, 15)),
    "flat_data": dict(data=torch.zeros(1025 * 16)),
    "noncontig_data": dict(data=torch.zeros(16, 1025).T),
    "unaligned_data": dict(data=torch.zeros(1025 * 16 + 1)[1:].view(1025, 16)),
    "int32_count": dict(count=torch.tensor(1000, dtype=torch.int32)),
    "short_tinv": dict(tinv=torch.eye(4)[:3]),
    "f64_time": dict(t_now=torch.tensor(T_NOW, dtype=torch.float64)),
    "mode": dict(mode=3),
    "splat_k": dict(splat_k=9),
    "no_image": dict(width=0),
}


@pytest.mark.parametrize("change", list(_BAD.values()), ids=list(_BAD))
def test_wrapper_rejects_what_the_kernel_cannot_take(on_cpu_card, change):
    """Each argument the kernel cannot read raises `ValueError` before a
    launch (the kernel device made the CPU, so that nothing else is wrong),
    and nothing is counted."""
    before = launches.COUNTS.copy()
    with pytest.raises(ValueError):
        zbuffer.render_full(**_valid_args(**change))
    assert launches.COUNTS == before and not on_cpu_card.calls


def test_wrapper_rejects_cpu_tensors():
    """The kernel runs on the card only: CPU tensors raise, nothing is built
    or counted."""
    before = launches.COUNTS.copy()
    with pytest.raises(ValueError, match="cuda"):
        zbuffer.render_full(**_valid_args())
    assert launches.COUNTS == before


def test_binding_matches_its_source():
    """The binding's mirror of `zbuffer::Params` lists the source's fields in
    the source's order with the source's types; the modes and the largest
    splat size are the source's."""
    src = (cuda_build.CSRC / "zbuffer.cu").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1))
    c_types = {"const float*": "c_void_p", "const long long*": "c_void_p",
               "unsigned long long*": "c_void_p", "long long*": "c_void_p",
               "float*": "c_void_p", "long long": "c_longlong", "int": "c_int",
               "float": "c_float"}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        typ = next(t for t in c_types if decl.startswith(t + " "))
        fields += [(name.strip(), getattr(ctypes, c_types[typ]))
                   for name in decl[len(typ):].split(",")]
    assert fields == list(zbuffer._Params._fields_)
    consts = dict(re.findall(r"\b([A-Z][A-Z_]*) = (\d+)", src))
    assert [int(consts[f"MODE_{m.upper()}"]) for m in zbuffer.MODES] == [0, 1, 2]
    assert tuple(MODES[m] for m in zbuffer.MODES) == (0, 1, 2)
    assert 2 * int(consts["MAX_HALF"]) + 1 == zbuffer.MAX_SPLAT_K


def _reader():
    """The benchmark's reader of `render_full_device_ms`."""
    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "render_full_device_ms.py"
    spec = importlib.util.spec_from_file_location("render_full_device_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spanned", [True, False], ids=["this_program", "no_span"])
def test_the_benchmark_reads_the_span(spanned):
    """`render_full_device_ms` is the mean `render.full` span of the counted
    frames (host ms off the card), and nothing on a program without the
    span."""
    def rec(name, frame, ms):
        return types.SimpleNamespace(name=name, frame=frame, parent=-1, start_ns=0,
                                     end_ns=int(ms * 1e6), ms=ms, events=None)

    recs = [rec("frame", 10, 40.0), rec("loop.check", 10, 30.0), rec("frame", 11, 50.0),
            rec("frame", 12, 40.0)]
    if spanned:
        recs += [rec("render.full", 10, 3.0), rec("render.full", 11, 5.0),
                 rec("render.full", 12, 7.0)]
    st = {"on": True, "kept": {10, 12}, "probed": set(), "recs": recs, "stages": {},
          "timer": timer}
    ctx = types.SimpleNamespace(on_card=False, probes={
        "spans": st, "zbuffer_launches0": launches.total("zbuffer")})
    value = _reader().read(ctx)
    assert value == (pytest.approx(5.0) if spanned else None)


# ----------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,kw",
    [("inactive", {}), ("all", {}), ("active", {}), ("all", dict(splat_k=5, depth_max=3.0))],
    ids=["inactive", "all", "active_unwindowed", "all_k5_near"],
)
def test_kernel_matches_the_exact_path(cuda, mode, kw):
    """K3 against the op-by-op exact path on the card, on a map of more than
    1<<21 rows with live-looking rows above the count and equal-z ties:
    `index` and `cell` equal on every pixel, the float maps within 1e-6
    relative; one launch a render, the same bits again on a rerun."""
    data_np, count, ties = _map(FULL, seed=11)
    data = torch.from_numpy(data_np).to(cuda)
    before = launches.total("zbuffer")
    k = _render(data, count, MODES[mode], **kw)
    again = _render(data, count, MODES[mode], **kw)
    p = _render_ops(data, count, MODES[mode], **kw)
    torch.cuda.synchronize()
    assert launches.total("zbuffer") == before + 2
    assert torch.equal(k.index, p.index) and torch.equal(k.cell, p.cell)
    for name, t in k._asdict().items():
        assert torch.equal(t, again._asdict()[name]), name
        if t.dtype == torch.float32:
            torch.testing.assert_close(t, p._asdict()[name], rtol=1e-6, atol=0, msg=name)
    cell = k.cell.cpu().numpy()
    assert (cell >= 0).mean() > 0.2 and cell.max() < count
    assert int(k.index.max()) < count
    lower_won = np.isin(cell, ties[:, 0]).sum()
    assert lower_won > 0 and not np.isin(cell, ties[:, 1]).any()


def _render_ops(data, count, mode, **kw):
    return splat.render_ops(data, torch.tensor(count, device=data.device),
                            torch.from_numpy(_pose()).to(data.device), INTR, W, H, T_NOW,
                            time_delta=TIME_DELTA, mode=mode, **kw)


@pytest.mark.cuda
def test_kernel_is_two_launches_and_a_memset(cuda):
    """One call of the wrapper is the key buffer's memset and two kernels,
    counted from a CUDA graph of the call."""
    data_np, count, _ = _map(FULL, seed=13)
    data = torch.from_numpy(data_np).to(cuda)
    args = _valid_args(data=data, count=torch.tensor(count, device=cuda),
                       tinv=torch.linalg.inv(torch.from_numpy(_pose())).contiguous().to(cuda),
                       t_now=torch.tensor(T_NOW, device=cuda))
    assert cuda_build.kernels_per_call(lambda: zbuffer.render_full(**args)) == (2, 3)
