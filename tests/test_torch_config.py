"""The PyTorch port's configuration copy and its import boundary."""

import dataclasses
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
    """Importing every module of the port leaves jax and the JAX package out
    of `sys.modules` (the port must run where jax is not installed), and has
    no side effect: no thread (a server or a receiver), no native build."""
    code = (
        "import importlib, pkgutil, sys, threading\n"
        "import densemonoslam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
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
