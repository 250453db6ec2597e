"""The port's example entry points (`examples/torch_*.py`) on the CPU: the
synthetic trainer as a user starts it, the street trainer's loop, the KITTI
converter against the JAX package's `examples/convert_kitti.py` on the same
directory, the multi-host launcher, the synthetic run in both modes (its
frame-to-frame odometry against the JAX package's functions) and the
collaborative UDP session.  Every subprocess has its own time limit."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from densemonoslam_tpu.eval import ate_rmse as jate_rmse
from densemonoslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence
from densemonoslam_tpu.models.depthnet import DepthPredictor as JDepth
from densemonoslam_tpu.tracking import odometry as jodo
from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution
from densemonoslam_tpu_torch.io.datasets import KittiOdometryReader
from densemonoslam_tpu_torch.io.klg import KlgReader
from densemonoslam_tpu_torch.io.street import StreetSequence
from densemonoslam_tpu_torch.models.depthnet import WEIGHTS_DIR, DepthPredictor

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _run(script: str, *args, timeout: float = 180):
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(EXAMPLES / script), *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_depthnet_script_writes_weights(tmp_path):
    """`torch_train_depthnet.py --steps 3 --device cpu --out DIR` renders
    the four orbits, trains, writes the npz (the JAX keys) and the json the
    JAX trainer writes, then fails the <10% held-out assertion, as 3 steps
    must."""
    out = tmp_path / "w"
    proc = _run("torch_train_depthnet.py", "--steps", 3, "--device", "cpu", "--out", out)
    assert "148 train / 12 held-out frames" in proc.stdout, proc.stderr
    assert proc.returncode != 0 and "did not reach <10% relative error" in proc.stderr
    meta = json.loads((out / "depthnet_synthetic.json").read_text())
    assert meta["widths"] == [16, 32, 64] and meta["steps"] == 3 and meta["train_frames"] == 148
    assert meta["holdout_rel_err"] >= 0.10
    with np.load(out / "depthnet_synthetic.npz") as z:
        assert "ConvBlock_0/Conv_0/kernel" in z.files and z["Conv_0/kernel"].shape == (3, 3, 16, 1)


def test_street_trainer_loop(tmp_path):
    """The street trainer's loop at a small size: both resolutions' batches
    (every third a KITTI-lap batch of 2), the held-out errors at both, and
    the json with `train_res`; the saved weights predict as the trained net."""
    mod = _example("torch_train_depthnet_street")
    laps, _ = mod.sequences(30)
    frames = [seq.frame(i) for seq in laps for i in range(len(seq))]
    cam = CameraConfig(FrameResolution(128, 40), CameraIntrinsics(60.0, 60.0, 63.5, 19.5), "small")
    lap = StreetSequence(camera=cam, num_frames=12, radius=44.0, exposure_jitter=0.05)
    frames_k = [lap.frame(i) for i in range(12)]
    res = mod.train(frames, frames_k, steps=6, device="cpu", out=tmp_path)
    assert len(res["losses"]) == 6 and np.all(np.isfinite(res["losses"]))
    meta = json.loads((tmp_path / "depthnet_street.json").read_text())
    assert meta["train_res"] == [80, 256] and meta["held_out_rel_err_kitti"] == res["rel_kitti"]
    port = DepthPredictor(widths=(16, 32, 64), min_depth=2.0, max_depth=80.0, device="cpu")
    port.load(res["path"])
    d = port.predict(frames[0][0]).numpy()
    assert d.shape == (80, 256) and 2.0 <= d.min() and d.max() <= 80.0


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A KITTI-layout sequence: 3 colour frames `image_2/%06d.png`, a depth
    dir of uint16 mm PNGs with the same names, and 3 rows of poses."""
    from PIL import Image

    root = tmp_path_factory.mktemp("kitti")
    gen = np.random.default_rng(0)
    (root / "seq" / "image_2").mkdir(parents=True)
    (root / "depth").mkdir()
    for i in range(3):
        rgb = gen.integers(0, 256, (38, 124, 3)).astype(np.uint8)
        Image.fromarray(rgb).save(root / "seq" / "image_2" / f"{i:06d}.png")
        depth = gen.integers(0, 20000, (38, 124)).astype(np.uint16)
        Image.fromarray(depth).save(root / "depth" / f"{i:06d}.png")
    poses = [np.hstack([np.eye(3) + 0.01 * gen.normal(size=(3, 3)), gen.normal(size=(3, 1))])
             for _ in range(3)]
    (root / "poses.txt").write_text("".join(" ".join(f"{v:.6e}" for v in p.ravel()) + "\n"
                                            for p in poses))
    return root


def _klg_depths_mm(path, w, h) -> np.ndarray:
    reader = KlgReader(str(path), w, h, depth_factor=1.0, prefetch=False)
    return np.stack([reader.get_next()[1] for _ in range(len(reader))])


def test_convert_kitti_matches_reference(kitti, tmp_path):
    """The twin on a KITTI directory with `--depth-dir`, `--gt` and
    `--gt-out`: its `.klg` and `.freiburg` are byte-equal to what
    `examples/convert_kitti.py` writes under JAX on the CPU."""
    common = ["--seq", kitti / "seq", "--depth-dir", kitti / "depth", "--gt", kitti / "poses.txt",
              "--feed-width", 64, "--feed-height", 20]
    outs = {}
    for who, script in (("jax", "convert_kitti.py"), ("port", "torch_convert_kitti.py")):
        outs[who] = (tmp_path / f"{who}.klg", tmp_path / f"{who}.freiburg")
        proc = _run(script, *common, "--out", outs[who][0], "--gt-out", outs[who][1])
        assert proc.returncode == 0, proc.stderr
        assert "wrote 3 frames" in proc.stdout
    for a, b in zip(outs["jax"], outs["port"]):
        assert a.read_bytes() == b.read_bytes(), b.name
    assert np.any(_klg_depths_mm(outs["port"][0], 64, 20) > 0)


def test_convert_kitti_predicted_depth(kitti, tmp_path):
    """`--predict-depth`: on an npz the JAX `DepthPredictor()` saved at its
    default widths (the only kind the JAX script can load, ROADMAP R9) the
    twin's depths are within 1 mm of the JAX script's; on the packaged
    synthetic file the twin takes widths and depth range from the json
    beside it and writes the packaged net's depths."""
    jp = JDepth(seed=1)
    jp.init_for(32, 64)
    jp.save(str(tmp_path / "default.npz"))
    depths = {}
    for who, script in (("jax", "convert_kitti.py"), ("port", "torch_convert_kitti.py")):
        extra = ["--device", "cpu"] if who == "port" else []
        out = tmp_path / f"{who}.klg"
        proc = _run(script, "--seq", kitti / "seq", "--out", out, "--predict-depth",
                    tmp_path / "default.npz", "--feed-width", 64, "--feed-height", 32, *extra)
        assert proc.returncode == 0, proc.stderr
        depths[who] = _klg_depths_mm(out, 64, 32)
    assert np.all(depths["port"] > 0)
    np.testing.assert_allclose(depths["port"], depths["jax"], atol=1.0)

    out = tmp_path / "packaged.klg"
    convert = _example("torch_convert_kitti")
    assert convert.main(["--seq", str(kitti / "seq"), "--out", str(out), "--frames", "2",
                         "--predict-depth", str(WEIGHTS_DIR / "depthnet_synthetic.npz"),
                         "--feed-width", "160", "--feed-height", "120", "--device", "cpu"]) == 0
    got = _klg_depths_mm(out, 160, 120)
    reader = KittiOdometryReader(str(kitti / "seq"), feed_width=160, feed_height=120)
    pred = DepthPredictor.pretrained_synthetic(device="cpu")
    want = np.stack([(pred.predict(reader.get_next()[0]).numpy() * 1000.0).astype(np.uint16)
                     for _ in range(2)])
    assert got.shape == (2, 120, 160) and 500 <= got.min() and got.max() <= 10000
    np.testing.assert_allclose(got, want, atol=1.0)


def test_run_multihost_two_hosts():
    """`torch_run_multihost.py --hosts 2 --frames 2 --device cpu`: both
    hosts finish, and both see the same per-camera surfels every frame."""
    proc = _run("torch_run_multihost.py", "--hosts", 2, "--frames", 2, "--device", "cpu",
                timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    views = {0: [], 1: []}
    for line in proc.stdout.splitlines():
        if line.startswith("[host "):
            host, rest = line[len("[host "):].split(" view] ")
            views[int(host)].append(rest)
    assert "host 0 done (2-camera session)" in proc.stdout
    assert "host 1 done (2-camera session)" in proc.stdout
    assert len(views[0]) == 2 and views[0] == views[1], views


def _number(text: str, before: str, after: str) -> float:
    return float(text.split(before, 1)[1].split(after, 1)[0])


def test_run_synthetic_odometry_only():
    """`torch_run_synthetic.py --odometry-only --frames 20 --platform cpu`
    tracks every frame and exits 0 (ATE < 20 mm); its ATE lies within
    0.5 mm of the JAX package's frame-to-frame chain on the same frames,
    called in this process as `examples/run_synthetic.py` calls it (0.5 mm:
    the per-pose bound of the 20-frame chain in `test_torch_tracking.py`,
    f32 GN in two summation orders compounded over 19 frames).  20
    frames, not fewer: the orbit spans the sequence, so with 8 frames the
    frames are ~45 degrees apart and both packages fail every pair."""
    import jax.numpy as jnp

    frames = 20
    proc = _run("torch_run_synthetic.py", "--odometry-only", "--frames", frames,
                "--platform", "cpu", timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "failures: 0" in proc.stdout, proc.stdout
    ate_mm = _number(proc.stdout, "ATE: ", " mm")
    seq = JSyntheticSequence(num_frames=frames, radius=0.35, max_angle=0.3)
    intr = seq.camera.intrinsics
    poses, prev = [seq.gt_pose(0)], None
    for i in range(frames):
        rgb, depth = seq.frame(i)
        cur = jodo.build_frame_pyramid(jnp.asarray(rgb), jnp.asarray(depth), intr, 3)
        if prev is not None:
            res = jodo.track(jodo.model_pyramid_from_frame(prev), cur,
                             jnp.eye(4, dtype=jnp.float32), intr)
            poses.append(poses[-1] @ np.asarray(res.A))
        prev = cur
    ref_mm = 1e3 * jate_rmse(poses, [seq.gt_pose(i) for i in range(frames)])
    assert abs(ate_mm - ref_mm) < 0.5, (ate_mm, ref_mm)


def test_run_synthetic_engine_exports(tmp_path):
    """The full-engine mode with `--out`: exit 0 (ATE < 20 mm) and the four
    exports, the trajectory one row per frame."""
    out = tmp_path / "out"
    proc = _run("torch_run_synthetic.py", "--frames", 20, "--platform", "cpu", "--out", out,
                timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _number(proc.stdout, "ATE: ", " mm") < 20.0
    assert np.loadtxt(out / "synthetic.freiburg").shape == (20, 8)
    assert {p.name for p in out.iterdir()} == {
        "synthetic.freiburg", "map.ply", "timings.csv", "run.stats"}


def test_run_collaborative_merges():
    """`torch_run_collaborative.py --platform cpu`: both UDP senders' 14
    frames processed, the maps merge (exit 0), and camB's pose relative to
    camA's after the merge is the true one (frames 13 and 19 of the orbit)
    within 1 cm."""
    proc = _run("torch_run_collaborative.py", "--platform", "cpu", timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "*** maps merged after" in proc.stdout
    assert "frames: {'camA': 14, 'camB': 14}; maps: 1;" in proc.stdout
    rel = np.array(proc.stdout.split("translation: [", 1)[1].split("]", 1)[0].split(), float)
    seq = JSyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    truth = (np.linalg.inv(seq.gt_pose(13)) @ seq.gt_pose(19))[:3, 3]
    np.testing.assert_allclose(rel, truth, atol=0.01)


def test_bench_ablate_twin_matches_reference_tables():
    """`torch_bench_ablate.py` sweeps the JAX script's `BASE` and `VARIANTS`,
    and one variant's `run` times frames on the CPU (a 64x48 orbit)."""
    ref, twin = _example("bench_ablate"), _example("torch_bench_ablate")
    assert twin.BASE == ref.BASE and twin.VARIANTS == ref.VARIANTS
    cam = CameraConfig(FrameResolution(64, 48), CameraIntrinsics(52.8, 52.8, 31.5, 23.5), "t")
    assert twin.run("base", {}, n_frames=2, warmup=1, device="cpu", cam=cam) > 0


def test_xbench_times_one_case_on_the_cpu(capsys):
    """`torch_xbench.xbench` on one CPU case: ms per call, and the per-op
    table it prints names the case's operators with their times."""
    xb = _example("torch_xbench")
    a = torch.from_numpy(np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32))
    res = xb.xbench({"matmul": (lambda x: x @ x, (a,))}, iters=5, top=3)
    assert set(res) == {"matmul"} and res["matmul"] > 0
    out = capsys.readouterr().out
    assert "matmul" in out and "ms/call  (cpu)" in out and "aten::" in out
