"""On the card: the control fails.  The reference computed in TF32 (one
precision below the configurations' float32 with TF32 off) is put in the
program's place for every reading of each cell, at the cell's own size, on
three seeds: the harness judges the program correct and the control, by
the same limits and the same code, not correct.  Run with
``python -m pytest -m cuda benchmark/tests``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("rgbd_vga.revisit_lap", "mono_kitti.street", "rgbd_vga_odometry.lap", "rgbd_vga.live_22hz")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_the_control_fails_where_the_program_passes(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card computes")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "20", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{cell} seed {seed}: program {json.dumps(result['checks'])} "
          f"control {json.dumps(result['control_checks'])}")
    assert result["correct"] is True, result["checks"]
    assert result["control_correct"] is False, result["control_checks"]
