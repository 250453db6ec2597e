"""The benchmark's files on their own: the frozen generators against the
port's, the roofline arithmetic against hand counts, what the benchmark
imports, and `BENCHMARK.json` against the rules its readers hold it to."""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import roofline  # noqa: E402
from traffic import frames as framesmod  # noqa: E402
from traffic.camera import CameraConfig, CameraIntrinsics, FrameResolution  # noqa: E402
from traffic.orbit import SyntheticSequence  # noqa: E402
from traffic.street import StreetSequence  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("kind", ["orbit", "street"])
def test_frozen_generators_match_the_ports(kind):
    from densemonoslam_tpu_torch import config as pc
    from densemonoslam_tpu_torch.io import street as pstreet
    from densemonoslam_tpu_torch.io import synthetic as psynth

    if kind == "orbit":
        kw = dict(num_frames=40, radius=0.35, max_angle=0.3)
        res, intr = (160, 120), (132.0, 132.0, 79.5, 59.5)
        ours = SyntheticSequence(camera=CameraConfig(FrameResolution(*res), CameraIntrinsics(*intr)), **kw)
        port = psynth.SyntheticSequence(camera=pc.CameraConfig(pc.FrameResolution(*res),
                                                               pc.CameraIntrinsics(*intr), "c"), **kw)
        idx = (0, 17, 39)
    else:
        kw = dict(num_frames=520, exposure_jitter=0.03)
        ours, port = StreetSequence(**kw), pstreet.StreetSequence(**kw)
        idx = (0, 301)
    for i in idx:
        for a, b in zip(ours.frame(i), port.frame(i)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(ours.gt_pose(i), port.gt_pose(i))


@pytest.mark.parametrize("i", [0, 137, 301])
def test_the_street_rendered_on_a_device_equals_the_hosts(i):
    import torch

    from traffic import street_device

    cam = CameraConfig(FrameResolution(1024, 320), CameraIntrinsics(707.09, 707.09, 601.89, 183.11))
    seq = StreetSequence(camera=cam, num_frames=520, exposure_jitter=0.03)
    for a, b in zip(seq.frame(i), street_device.frame(seq, i, torch.device("cpu"))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_every_run_replays_the_lap_from_its_first_frame():
    cam = CameraConfig(FrameResolution(32, 24), CameraIntrinsics(26.4, 26.4, 15.5, 11.5))
    mix = {"trajectory": "orbit", "lap": 40, "warmup_frames": 3,
           "sequence": {"radius": 0.35, "max_angle": 0.3}}
    t = framesmod.make(mix, cam, workers=1)
    assert len(t.lap_frames) == 40 and t.warmup == 3
    assert [t.index(j) for j in (0, 1, 39, 40, 41, 85)] == [0, 1, 39, 0, 1, 5]
    assert np.array_equal(t.frame(40)[0], t.frame(0)[0])


def test_roofline_arithmetic_against_hand_counts():
    # K1 at 76800x16: 76800*16*4 + 16*16*4 bytes at 3.35 TB/s, bytes-bound
    b, f = roofline.gram_work(76800, 16)
    assert b == 4 * (76800 * 16 + 256) and f == 2 * 76800 * 256
    assert roofline.bound_s(b, f) == pytest.approx(1.4675e-6, rel=1e-4)
    # K2 over 1<<20 rows, 816,560 live, 256 nodes
    assert roofline.bound_s(*roofline.deform_work(1 << 20, 816560, 256)) == pytest.approx(
        15.87e-6, rel=1e-3)
    # the depth CNN's U-Net at KITTI 1024x320: 83.8 GFLOP a frame
    assert roofline.depthnet_flop(320, 1024) == pytest.approx(83.80219392e9, rel=1e-9)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "densemonoslam_tpu"}, tops
    if "reference" in path.relative_to(BENCH).parts or "traffic" in path.relative_to(BENCH).parts:
        assert "densemonoslam_tpu_torch" not in tops, tops


def test_benchmark_json_keeps_to_its_rules():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and spec["paths"] == ["benchmark"]
    configs = {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in spec["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        reader = (BENCH / "metrics" / f"{m['name']}.py").read_text()
        for key in ("unit", "layer", "moves", "source"):
            assert f'{key.upper()} = "{m[key]}"' in reader, (m["name"], key)
