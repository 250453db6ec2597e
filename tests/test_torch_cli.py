"""The PyTorch port's command line (`python -m densemonoslam_tpu_torch.cli`)
and its `Stopwatch`, on the CPU: mirrors of
`tests/test_checkpoint_cli.py::test_cli_synthetic_run` and
`tests/test_camera_manager.py::test_cli_multi_camera_session`, a
`--checkpoint` then `--resume` run, the refusal to run without a card unless
`--platform cpu`, and the exports' formats against the JAX package's
writers.  Every subprocess has its own time limit."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from densemonoslam_tpu.utils.stats import SessionStats as JStats
from densemonoslam_tpu.utils.timer import Stopwatch as JStopwatch
from densemonoslam_tpu_torch.eval import ate_rmse
from densemonoslam_tpu_torch.io.datasets import load_freiburg_trajectory
from densemonoslam_tpu_torch.io.klg import write_klg
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.utils.timer import Stopwatch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = ["--dataset", "synthetic", "--no-nid", "--open-loop", "--max-surfels", str(1 << 17)]


def _cli(*args, timeout=300, env=None):
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "densemonoslam_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )


def _ate_mm(stdout):
    return float(stdout.split("ATE RMSE vs analytic GT:")[1].split("mm")[0])


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """8 synthetic frames on the CPU, exported and checkpointed."""
    d = tmp_path_factory.mktemp("cli")
    out, ckpt = d / "run", d / "state.npz"
    proc = _cli("--platform", "cpu", "--frames", "8", *SYNTH, "--out", str(out),
                "--checkpoint", str(ckpt))
    return proc, out, ckpt, d


def test_cli_synthetic_run(synthetic_run):
    """The four exports of the reference's `--q` run, ATE < 20 mm (the JAX
    test's bound), the fps line with the `frame_dispatch` mean beside it."""
    proc, out, ckpt, _ = synthetic_run
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "processed 8 frames at" in proc.stdout and "frame_dispatch mean" in proc.stdout
    for f in ["trajectory.freiburg", "map.ply", "run.stats", "timings.csv"]:
        assert (out / f).exists(), f
    assert _ate_mm(proc.stdout) < 20.0
    assert ckpt.exists()


def test_cli_exports_match_reference_writers(synthetic_run):
    """`timings.csv` has the JAX engine's one section (`frame_dispatch`,
    `densemonoslam_tpu/engine.py:402,510`), and both files are byte for byte
    what the JAX package's `Stopwatch.write_csv` and `SessionStats.write`
    make of the same values."""
    _, out, _, d = synthetic_run
    lines = (out / "timings.csv").read_text().splitlines()
    assert lines[0] == "frame_dispatch" and len(lines) == 9
    sw = JStopwatch()
    sw.timings["frame_dispatch"] = [float(x) for x in lines[1:]]
    sw.write_csv(str(d / "jax_timings.csv"))
    assert (d / "jax_timings.csv").read_bytes() == (out / "timings.csv").read_bytes()

    rows = (out / "run.stats").read_text().splitlines()
    summary = dict(kv.split("=") for kv in rows[-1][2:].split())
    st = JStats()
    for row in rows[:-1]:
        _, nid, n, fused = row.split()
        st.record(float(nid), int(n), bool(int(fused)))
    st.keyframes = int(summary["keyframes"])
    st.write(str(d / "jax.stats"))
    assert (d / "jax.stats").read_bytes() == (out / "run.stats").read_bytes()
    assert len(rows) == 9


def test_cli_resume_continues_the_session(synthetic_run, tmp_path):
    """`--resume` restores the checkpoint at tick 8 and replays frames 8-15;
    the exported trajectory has all 16 poses and stays on the truth."""
    _, _, ckpt, _ = synthetic_run
    out = tmp_path / "resumed"
    proc = _cli("--platform", "cpu", "--frames", "8", "--skip", "8", *SYNTH,
                "--resume", str(ckpt), "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "at tick 8" in proc.stdout
    assert _ate_mm(proc.stdout) < 20.0
    ts, poses = load_freiburg_trajectory(str(out / "trajectory.freiburg"))
    assert ts.tolist() == [float(i) for i in range(16)]
    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    assert ate_rmse(list(poses), [seq.gt_pose(i) for i in range(16)]) < 0.02


def test_cli_pose_injection_clusters_depth_net_and_viewer(tmp_path):
    """`--poses` injects the ground truth (ATE ~0), `--clusters` tags the
    frames, `--predict-depth` takes depth from the packaged synthetic net,
    and `--viewer 0` serves and publishes during the run."""
    from densemonoslam_tpu_torch.io.writers import save_freiburg

    seq = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)
    poses = tmp_path / "gt.freiburg"
    save_freiburg(str(poses), [float(i) for i in range(6)], [seq.gt_pose(i) for i in range(6)])
    clusters = tmp_path / "clusters.csv"
    clusters.write_text("0,0\n3,1\n")
    proc = _cli("--platform", "cpu", "--frames", "6", *SYNTH, "--poses", str(poses),
                "--clusters", str(clusters), "--predict-depth", "--viewer", "0",
                "--viewer-interval", "2", "--out", str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "viewer: http://127.0.0.1:" in proc.stdout
    assert _ate_mm(proc.stdout) < 1e-2
    assert (tmp_path / "run" / "map.ply").exists()


def test_cli_refuses_the_cpu_without_platform_flag(tmp_path):
    """With no card visible and no `--platform cpu`, the CLI exits with the
    error and processes nothing (it never picks the CPU by itself)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _cli("--frames", "2", *SYNTH, "--out", str(tmp_path / "x"), env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--platform cpu" in proc.stderr
    assert "processed" not in proc.stdout and not (tmp_path / "x").exists()


def test_cli_multi_camera_session(tmp_path):
    """Mirror of `test_cli_multi_camera_session`: `--logs a.klg b.klg` runs a
    two-camera session through the CLI and exports per-camera trajectories
    and per-map clouds."""
    from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution

    W, H = 96, 72
    cam = CameraConfig(FrameResolution(W, H), CameraIntrinsics(79.2, 79.2, W / 2 - 0.5,
                                                               H / 2 - 0.5), "cam")
    seq = SyntheticSequence(camera=cam, num_frames=16)
    logs = []
    for name, start in (("a", 0), ("b", 4)):
        frames = []
        for i in range(start, start + 6):
            rgb, depth = seq.frame(i)
            frames.append((rgb, (depth * 1000).astype(np.uint16), i))
        logs.append(str(tmp_path / f"{name}.klg"))
        write_klg(logs[-1], frames)
    out = tmp_path / "multi"
    proc = _cli("--platform", "cpu", "--logs", *logs, "--width", str(W), "--height", str(H),
                "--frames", "5", "--open-loop", "--no-nid", "--max-surfels", str(1 << 14),
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "processed 10 frames over 2 cameras" in proc.stdout
    for f in ["cam0.freiburg", "cam1.freiburg", "cam0.ply", "cam1.ply"]:
        assert (out / f).exists(), f


def test_stopwatch_matches_reference(tmp_path):
    """From the same timings (ragged columns included) the port's
    `Stopwatch` writes the same CSV bytes and sends the same UDP packet as
    the JAX package's."""
    timings = {"frame_dispatch": [12.5, 3.25, 7.0], "loop": [101.125], "b": [0.5, 0.25]}
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    try:
        packets, files = [], []
        for i, sw in enumerate((JStopwatch(), Stopwatch())):
            for k, v in timings.items():
                sw.timings[k] = list(v)
            files.append(tmp_path / f"t{i}.csv")
            sw.write_csv(str(files[-1]))
            sw.enable_udp(port=rx.getsockname()[1])
            sw._maybe_send()
            packets.append(rx.recv(65536))
            assert sw.mean("frame_dispatch") == pytest.approx(22.75 / 3)
            assert sw.last("loop") == 101.125
            assert sw.summary() == {k: sum(v) / len(v) for k, v in timings.items()}
        assert files[0].read_bytes() == files[1].read_bytes()
        assert packets[0] == packets[1]
        sw = Stopwatch()
        with sw.section("s", block=[torch.zeros(1), {"a": (torch.ones(2),)}]):
            pass
        sw.tock("t", sw.tick("t"), block=torch.zeros(1))
        assert len(sw.timings["s"]) == len(sw.timings["t"]) == 1
        assert int.from_bytes(packets[1][:4], "little") == len(packets[1])
    finally:
        rx.close()
