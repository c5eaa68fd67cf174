"""The port's measuring helpers (``measure.py``) against ``bench.py``'s,
and the two tools built on them, ``tools/perf_decomp_torch.py`` and
``tools/remat_search_torch.py``, rehearsed on the CPU at tiny sizes.

A CPU run measures the CPU: its MFU and fractions of peak are None, and
no number here is a device metric."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# the tiny steps gain nothing from threads, and the tool's subprocess would
# contend with the other test workers for every core
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PRESETS = ("tiny", "llama3_1b")
POLICIES = ("dots", "ffn", "ffn_lite", "full")


def _cfgs(preset, **kw):
    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator_torch.models import llama as tllama

    return (dataclasses.replace(getattr(tllama.LlamaConfig, preset)(), **kw),
            dataclasses.replace(getattr(jllama.LlamaConfig, preset)(), **kw))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("seq", [32, 2048])
def test_train_flops_per_token_is_bench_formula(preset, seq):
    import bench

    from tpu_network_operator_torch import measure

    tcfg, jcfg = _cfgs(preset)
    assert measure.train_flops_per_token(tcfg, seq) == \
        bench.train_flops_per_token(jcfg, seq)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("opt8", [False, True])
def test_train_mem_estimate_is_bench_formula(preset, policy, opt8):
    import bench

    from tpu_network_operator_torch import measure

    for chunk in (0, 512):
        tcfg, jcfg = _cfgs(preset, remat_policy=policy, xent_chunk=chunk)
        assert measure.train_mem_estimate(tcfg, 4, 2048, opt8) == \
            bench.train_mem_estimate(jcfg, 4, 2048, opt8), chunk


@pytest.mark.parametrize("preset", PRESETS)
def test_ffn_offload_charges_the_carry_alone(preset):
    """The saved set lives in pinned host memory on CUDA, so only the
    layer carry (hidden per token) is charged, as the reference charges
    the TPU: the "full" policy's residency."""
    from tpu_network_operator_torch import measure

    off, _ = _cfgs(preset, remat_policy="ffn_offload", xent_chunk=512)
    full, _ = _cfgs(preset, remat_policy="full", xent_chunk=512)
    ffn, _ = _cfgs(preset, remat_policy="ffn", xent_chunk=512)
    for opt8 in (False, True):
        est = measure.train_mem_estimate(off, 4, 2048, opt8)
        assert est == measure.train_mem_estimate(full, 4, 2048, opt8)
        carry = 4 * 2048 * off.hidden * off.layers * 2
        assert est == (off.num_params() * (6 if opt8 else 8)
                       + 4 * 512 * off.vocab_size + carry)
        assert est < measure.train_mem_estimate(ffn, 4, 2048, opt8)


def test_peaks_by_sku_and_refusal():
    from tpu_network_operator_torch import measure

    assert measure.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert measure.peak_flops("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(ValueError, match="no published peaks"):
        measure.peak_flops("NVIDIA A100-SXM4-80GB")
    assert measure.device_bytes("cpu") is None
    assert measure.power_limit_w("cpu") is None


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(**kw):
    from tpu_network_operator_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), remat=True,
                               xent_chunk=16, **kw)


def test_measure_row_on_the_cpu():
    from tpu_network_operator_torch import measure

    row = measure.measure("tiny/full/adamw/b2", _tiny(remat_policy="full"),
                          2, 32, "cpu", iters=2, log=lambda _: None)
    assert set(row) == {"config", "tokens_per_sec_per_chip", "mfu", "batch",
                        "seq", "loss"}
    assert row["mfu"] is None and 0 < row["loss"] < 20
    assert row["tokens_per_sec_per_chip"] > 0


def test_decompose_has_the_reference_keys():
    """``decompose`` at tiny on the CPU: the reference's JSON keys
    (``mxu_probe`` named ``matmul_probe``; the card's power limit and the
    step's loss added), ``optimizer`` exactly ``step - grad``."""
    from tpu_network_operator_torch import measure

    out = measure.decompose(_tiny(remat_policy="full"), 2, 32, iters=2,
                            device="cpu", name="tiny")
    assert set(out) == {"metric", "value", "unit", "vs_baseline",
                        "device_kind", "power_limit_w", "batch", "seq",
                        "remat_policy", "loss", "seconds", "mfu",
                        "multipliers", "matmul_probe"}
    assert 0 < out["loss"] < 20
    sec = out["seconds"]
    assert set(sec) == {"fwd", "grad", "step", "optimizer",
                        "bwd_plus_remat"}
    assert sec["optimizer"] == sec["step"] - sec["grad"]
    assert sec["bwd_plus_remat"] == sec["grad"] - sec["fwd"]
    assert all(t > 0 for t in (sec["fwd"], sec["grad"], sec["step"]))
    assert set(out["mfu"]) == {"fwd_only", "grad", "full_step"}
    assert all(v is None for v in out["mfu"].values())
    assert out["multipliers"]["grad_over_fwd"] == sec["grad"] / sec["fwd"]
    assert set(out["matmul_probe"]) == {"shape", "tflops",
                                        "fraction_of_peak"}
    assert out["matmul_probe"]["shape"] == [64, 64, 64]
    assert out["matmul_probe"]["fraction_of_peak"] is None
    assert (out["device_kind"], out["power_limit_w"]) == ("cpu", None)
    assert out["metric"] == "tiny perf decomposition"
    assert out["value"] == 64 / sec["step"]
    json.dumps(out)


def test_remat_search_tool_writes_every_row(tmp_path):
    out = tmp_path / "rows.jsonl"
    run = subprocess.run(
        [sys.executable, "tools/remat_search_torch.py", "--config", "tiny",
         "--device", "cpu", "--batches", "2", "--seq", "32",
         "--xent-chunk", "16", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, **ONE_THREAD})
    assert run.returncode == 0, run.stderr[-2000:]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 10
    assert {r["config"] for r in rows} == {
        f"tiny/{p}/{o}/b2" for p in ("dots", "ffn", "ffn_offload",
                                     "ffn_lite", "full")
        for o in ("adam8", "adamw")}
    best = json.loads(run.stdout.strip().splitlines()[-1])
    assert best["metric"].endswith("remat-search best")
    assert best["value"] == max(r["tokens_per_sec_per_chip"] for r in rows)
    assert len(best["rows"]) == 10


def test_remat_search_goes_on_past_an_oom_and_only_an_oom(monkeypatch):
    """A rung out of device memory is a ``fail`` and the sweep goes on;
    any other error fails the sweep (no kernel fault passes as an OOM);
    a combination over the memory budget is skipped."""
    from tpu_network_operator_torch import measure

    def fake(name, cfg, batch, seq, device, optimizer, iters, log):
        if cfg.remat_policy == "dots":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"config": name, "tokens_per_sec_per_chip": float(batch),
                "mfu": None, "batch": batch, "seq": seq, "loss": 5.0}

    monkeypatch.setattr(measure, "measure", fake)
    logs = []
    res = measure.remat_search(_tiny(), "tiny", [2, 4], ["adam8", "adamw"],
                               32, 16, "cpu", log=logs.append)
    assert len(res["rows"]) == 16 and len(res["failed"]) == 4
    assert sum(line.startswith("fail tiny/dots/") for line in logs) == 4
    assert res["best"]["value"] == 4.0

    def broken(*args):
        raise RuntimeError("an illegal memory access was encountered")

    monkeypatch.setattr(measure, "measure", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        measure.remat_search(_tiny(), "tiny", [2], ["adamw"], 32, 16, "cpu",
                             log=logs.append)

    monkeypatch.setattr(measure, "measure", fake)
    monkeypatch.setattr(measure, "device_bytes", lambda dev: 1 << 16)
    with pytest.raises(RuntimeError, match="no policy/batch combination"):
        measure.remat_search(_tiny(), "tiny", [2], ["adamw"], 32, 16, "cpu",
                             log=logs.append)
    assert logs[-1].startswith("skip tiny/full/adamw/b2: est")


def test_perf_decomp_refuses_a_world_above_one():
    """Under a 2-rank torch.distributed world each rank prints the
    reference's ``error`` line and exits 1, before any work."""
    procs = [subprocess.Popen(
        [sys.executable, "tools/perf_decomp_torch.py", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, **ONE_THREAD, "WORLD_SIZE": "2", "RANK": str(r),
             "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": "1"})
        for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 1, err[-2000:]
        line = json.loads(out.strip().splitlines()[-1])
        assert line["value"] == 0.0 and line["unit"] == "mfu"
        assert "torch.distributed world of 2" in line["error"]


def test_measuring_entry_points_raise_without_cuda(monkeypatch):
    """CUDA unless the caller asks for the CPU: no card, a named error and
    no work on the CPU."""
    from tpu_network_operator_torch import measure

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: measure.measure("x", _tiny(), 2, 32),
                 lambda: measure.decompose(_tiny(), 2, 32),
                 lambda: measure.remat_search(_tiny(), "tiny", [2],
                                              ["adamw"], 32, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
