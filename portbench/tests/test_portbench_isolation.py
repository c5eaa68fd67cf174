"""No module a run loads has a top-level name of the JAX side, compared
whole: the port's own name begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import common

IMPORTS = """
import json, sys
import portbench.run, portbench.calibrate, portbench.trace
import portbench.drivers.train, portbench.drivers.decode
import portbench.drivers.allreduce
from portbench import common
for name in [m['name'] for m in common.benchmark()['per_layer']]:
    common.load_module('metrics', name)
from tpu_network_operator_torch.models import llama, moe, generate, optim8bit
from tpu_network_operator_torch.parallel import comm, mesh
print(json.dumps(common.forbidden_modules()))
"""


def test_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_network_operator_torch_extra",
                        sys)
    monkeypatch.setitem(sys.modules, "benchmarks", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    found = common.forbidden_modules()
    assert "tpu_network_operator_torch_extra" not in found
    assert "benchmarks" not in found
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in common.forbidden_modules()


def test_a_run_loads_nothing_of_the_jax_side():
    out = subprocess.run([sys.executable, "-c", IMPORTS], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_module():
    for path in common.HERE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in common.FORBIDDEN, (path, line)
