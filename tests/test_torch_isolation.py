"""The port stands alone: it imports neither JAX nor the JAX package, nor
``transformers`` or ``safetensors`` (the card's machine has neither), and
its entry points refuse to run on the CPU unless asked to."""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "tpu_network_operator_torch"
FORBIDDEN = ("jax", "tpu_network_operator", "transformers", "safetensors")


def port_modules():
    mods = []
    for path in sorted((ROOT / PACKAGE).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference_package():
    mods = port_modules() + ["chip_smoke"]
    assert f"{PACKAGE}.ops.flash_attention" in mods
    assert f"{PACKAGE}.workload.__main__" in mods
    assert {f"{PACKAGE}.data", f"{PACKAGE}.models.optim8bit",
            f"{PACKAGE}.models.checkpoint",
            f"{PACKAGE}.models.convert", f"{PACKAGE}.bootstrap",
            f"{PACKAGE}.parallel", f"{PACKAGE}.parallel.comm",
            f"{PACKAGE}.parallel.mesh", f"{PACKAGE}.parallel.ring",
            f"{PACKAGE}.parallel.ulysses", f"{PACKAGE}.parallel.collectives",
            f"{PACKAGE}.workload.collectives",
            f"{PACKAGE}.workload.execbench", f"{PACKAGE}.graft",
            f"{PACKAGE}.topology", f"{PACKAGE}.measure"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_exec_bench_launcher_imports_no_jax_workload(tmp_path):
    """``tools/exec_bench_torch.py`` runs the operator's probe -> plan ->
    agent bootstrap pipeline and imports no ``jax`` and none of the JAX
    workload's modules; no port module imports it."""
    workload = [f"tpu_network_operator.{m}"
                for m in ("models", "parallel", "ops", "workload")]
    code = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('eb', "
        "'tools/exec_bench_torch.py')\n"
        "eb = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(eb)\n"
        "plan, _, _ = eb.compute_scenario_plan(4, 'skewed', 1)\n"
        f"eb.write_rank_bootstraps({str(tmp_path)!r}, 't', 4, 2, plan)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] == 'jax' "
        f"or any(n == w or n.startswith(w + '.') for w in {workload!r}))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for path in [*(ROOT / PACKAGE).rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        imported = [a.name for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names]
        imported += [n.module or "" for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom)]
        assert not any("exec_bench" in m for m in imported), path
        assert "spec_from_file_location" not in path.read_text(), path


@pytest.mark.parametrize("tool", ["tools/perf_decomp_torch.py",
                                  "tools/remat_search_torch.py"])
def test_measuring_tools_import_no_jax_and_no_bench(tool):
    """The port's two measuring tools import no ``jax``, not ``bench.py``
    or ``__graft_entry__.py``, and nothing of the JAX package; no port
    module imports them."""
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('tool', {tool!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'bench', '__graft_entry__', 'tpu_network_operator'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    name = Path(tool).stem
    for path in [*(ROOT / PACKAGE).rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        imported = [a.name for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names]
        imported += [n.module or "" for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom)]
        assert not any(name in m for m in imported), path


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from tpu_network_operator_torch import resolve_device
    from tpu_network_operator_torch.models import convert as tconvert
    from tpu_network_operator_torch.models import generate as tgen
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.models import optim8bit as topt
    from tpu_network_operator_torch import bootstrap as tboot
    from tpu_network_operator_torch.parallel import mesh as tmesh
    from tpu_network_operator_torch.workload import cli, common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tllama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.params_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--preset", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--preset", "tiny", "--optimizer", "adam8bit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.make_train_step(cfg, optimizer="adam8bit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["convert", "--hf-path", "hf", "--checkpoint-dir", "ckpt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.load_hf_checkpoint("hf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.adam8_state_from_jax(None)
    # the mesh: the process group, the mesh and the sharded step
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.init_distributed(None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.init_distributed("jax-coordinator.json", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--preset", "tiny", "--tensor", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_process_group(tboot.BootstrapConfig(), None)
    # the collectives sweep and the exec bench: NCCL on the card, or
    # nothing (the bootstrap is read for its sha256 first)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["collectives"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["collectives", "--axis", "fsdp", "--tensor", "2"])
    boot = tmp_path / "jax-coordinator.json"
    boot.write_text(json.dumps({
        "version": 1, "coordinator_address": "127.0.0.1:1",
        "num_processes": 1, "process_id": 0,
        "topology": {"num_chips": 1, "chips_per_host": 1, "num_slices": 1}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["exec-bench", "--bootstrap", str(boot)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.make_train_step(cfg, mesh=SimpleNamespace(
            device=torch.device("cuda", 0)))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    # on the CPU the dispatchers take the plain versions; the kernel
    # wrappers themselves accept only CUDA tensors
    from tpu_network_operator_torch.models import optim8bit as topt
    from tpu_network_operator_torch.ops import flash_attention as tfa
    from tpu_network_operator_torch.ops import norms as tnorms

    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.fused_rms_norm(x, torch.ones(64))
    q = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_fwd_kernel(q, q, q, causal=True, seq_dim=1, head_dim=2)
    p = torch.zeros(4, 256, dtype=torch.bfloat16)
    opt = topt.adamw8bit()
    state = opt.init({"p": p})
    with pytest.raises(ValueError, match="CUDA"):
        topt.adam8_fused([(p, p.clone(), state["m"]["p"], state["v"]["p"])],
                         opt.consts(1))
