"""On the card, at each cell's own size: the program's run reads within
the cell's limits and the float8 control fails one of them.  Skips
without the devices the cell asks for (decided when the test runs)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import common

CELLS = [w["name"] for w in common.benchmark()["workloads"]]
SEED = 3_141_592_653


@pytest.fixture
def devices():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, devices):
    cell, _ = common.workload(name)
    if devices < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} CUDA devices")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.calibrate", "--workload", name,
         "--seed", str(SEED), "--seconds", "5", "--control"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    limits = cell["limits"]
    assert all(v <= limits[k] for k, v in got["compared"].items()), got
    assert any(v > limits[k] for k, v in got["control"].items()), got
