"""The PyTorch port's configuration copy and its import boundary."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import densemonoslam_tpu.config as jcfg
import densemonoslam_tpu_torch.config as tcfg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["FrameResolution", "EngineConfig"])
def test_config_defaults_match_reference(name):
    """Every field and default equals the reference package's."""
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = {f.name: f.default for f in dataclasses.fields(j)}
    tf = {f.name: f.default for f in dataclasses.fields(t)}
    assert tf == jf
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


@pytest.mark.parametrize("levels", [1, 3, 4, 5])
@pytest.mark.parametrize("fast", [False, True])
def test_config_derived_values_match_reference(levels, fast):
    jc = jcfg.EngineConfig(pyramid_levels=levels, fast_odom=fast)
    tc = tcfg.EngineConfig(pyramid_levels=levels, fast_odom=fast)
    assert tc.iterations_for_levels() == jc.iterations_for_levels()
    ji = jcfg.CameraConfig.tum_default().intrinsics
    ti = tcfg.CameraConfig.tum_default().intrinsics
    assert dataclasses.asdict(ti.scaled(levels)) == dataclasses.asdict(ji.scaled(levels))
    res = tcfg.FrameResolution(640, 480)
    assert dataclasses.asdict(tcfg.CameraIntrinsics.default_for(res)) == dataclasses.asdict(
        jcfg.CameraIntrinsics.default_for(jcfg.FrameResolution(640, 480))
    )
    assert (ti.matrix() == ji.matrix()).all()


@pytest.mark.parametrize("name", ["tum_default", "kitti_default"])
def test_camera_presets_match_reference(name):
    """The camera presets, field by field (KITTI's drives the monocular
    street leg)."""
    jc, tc = getattr(jcfg.CameraConfig, name)(), getattr(tcfg.CameraConfig, name)()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_port_never_imports_jax():
    """Importing every module of the port, the port's example entry points
    (`examples/torch_*.py`) and `torch_bench.py` leaves jax and the JAX
    package out of
    `sys.modules` (the port must run where jax is not installed), and has
    no side effect: no thread (a server or a receiver), no native build."""
    code = (
        "import importlib, importlib.util, pkgutil, sys, threading\n"
        "from pathlib import Path\n"
        "import densemonoslam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "examples = sorted(Path('examples').glob('torch_*.py'))\n"
        "assert len(examples) == 13, examples\n"
        "for path in [*examples, Path('torch_bench.py')]:\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'densemonoslam_tpu.')) or k == 'densemonoslam_tpu')\n"
        "print(len(mods))\n"
        "assert not bad, bad\n"
        "assert {'densemonoslam_tpu_torch.cli', 'densemonoslam_tpu_torch.viewer', 'densemonoslam_tpu_torch.io.native'} <= set(mods)\n"
        "assert sys.modules['densemonoslam_tpu_torch.io.native']._STATE is None  # nothing built or loaded\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # modules walked


def test_port_disables_tf32():
    import densemonoslam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_runs_without_the_jax_package(tmp_path):
    """The port and its example entry points, copied into a tree that holds
    no `densemonoslam_tpu`, with only that tree on the path: both packaged
    depth nets load from the port's own files and predict, one CPU train
    step runs, and the synthetic twin tracks three frames frame to frame.  A module that read a file of the JAX package would fail
    here, where an import check cannot see it."""
    tree = tmp_path / "tree"
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(REPO / "densemonoslam_tpu_torch", tree / "densemonoslam_tpu_torch",
                    ignore=ignore)
    (tree / "examples").mkdir()
    for path in (REPO / "examples").glob("torch_*.py"):
        shutil.copy(path, tree / "examples" / path.name)
    code = (
        "import importlib.util, sys\n"
        "import numpy as np, torch\n"
        "assert importlib.util.find_spec('densemonoslam_tpu') is None\n"
        "import densemonoslam_tpu_torch\n"
        f"assert densemonoslam_tpu_torch.__file__.startswith({str(tree)!r})\n"
        "from densemonoslam_tpu_torch.models.depthnet import DepthPredictor, make_train_step\n"
        "gen = np.random.default_rng(0)\n"
        "for name, shape in (('synthetic', (120, 160)), ('street', (80, 256))):\n"
        "    pred = getattr(DepthPredictor, 'pretrained_' + name)(device='cpu')\n"
        "    d = pred.predict(gen.integers(0, 256, shape + (3,)).astype(np.uint8))\n"
        "    assert d.shape == shape and bool(torch.isfinite(d).all())\n"
        "spec = importlib.util.spec_from_file_location('t', 'examples/torch_train_depthnet.py')\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "pred = DepthPredictor(widths=t.WIDTHS, min_depth=t.MIN_D, max_depth=t.MAX_D,\n"
        "                      device='cpu')\n"
        "step = make_train_step(pred.net, torch.optim.Adam(pred.net.parameters(), lr=t.LR))\n"
        "rgb = torch.from_numpy(gen.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32))\n"
        "loss = step(rgb, torch.from_numpy(gen.uniform(0.5, 10, (2, 48, 64)).astype(np.float32)))\n"
        "assert bool(torch.isfinite(loss))\n"
        "spec = importlib.util.spec_from_file_location('s', 'examples/torch_run_synthetic.py')\n"
        "s = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(s)\n"
        "odo = s.run_odometry(s.sequence(20), 3, 'cpu')\n"
        "assert odo['failures'] == 0 and odo['ate'] < 0.02, odo['ate']\n"
        "assert not [k for k in sys.modules\n"
        "            if k == 'jax' or k.startswith(('jax.', 'densemonoslam_tpu.'))]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, timeout=120,
        env=dict(env, PYTHONPATH=str(tree), OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
