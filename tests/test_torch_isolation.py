"""The port stands alone: it imports neither JAX nor the JAX package, nor
``transformers`` or ``safetensors`` (the card's machine has neither), and
its entry points refuse to run on the CPU unless asked to."""

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
            f"{PACKAGE}.parallel.ulysses"} <= set(mods)
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


def test_entry_points_raise_without_cuda(monkeypatch):
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
