"""The last line a run prints, and the per-layer readers on a trace whose
numbers are known."""

from __future__ import annotations

import io
import json
import sys

import pytest

from portbench import common, costs
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "limits"]


def test_last_line(monkeypatch):
    got = tiny.run("mistral-7b-l24.train-4k",
                   {"loss_gap": 1.0, "grad_norm_gap": 1.0,
                    "change_norm_gap": 1.0})
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    common.emit(got["result"], got["checks"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS
    assert isinstance(line["correct"], bool) and line["correct"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["limits"]) == {"loss_gap", "grad_norm_gap",
                                   "change_norm_gap"}
    assert err.getvalue().strip().splitlines()[-1].startswith(
        "check change_norm_gap")


class FakeReading:
    def __init__(self):
        self.busy_s, self.window_s, self.launches = 0.75, 1.0, 2550

    def kernel_s(self, *names):
        return 0.5 if names else 0.0

    def gemm_s(self, group):
        shapes = {"dispatch": [[2, 20480, 8192], [2, 8192, 4096]],
                  "expert": [[8, 5120, 4096], [8, 4096, 14336]]}
        return {k: 0.1 for k, s in shapes.items() if group(s) == k}


def _train_trace():
    _, cfg = common.workload("mixtral-8x7b-l4.train-8k")
    cell, _ = common.workload("mixtral-8x7b-l4.train-8k")
    return {"kind": "train", "config": cfg, "traffic": cell["traffic"],
            "device_kind": "NVIDIA H100 80GB HBM3", "steps": 10,
            "window_s": 10.0, "reading": FakeReading(), "profiled_steps": 2,
            "step_s": 0.9, "grad_s": 0.85, "leaves": [(1 << 20, 2)]}


def test_train_readers():
    t = _train_trace()
    read = {n: common.load_module("metrics", n).read(t) for n in (
        "mfu.train", "optimizer_ms.train", "dispatch_gemm_ms.train",
        "expert_gemm_ms.train", "idle_share.train", "flash_roofline.train",
        "adam8_roofline.train")}
    flops = costs.train_step_flops(t["config"], 2, 8192)
    assert read["mfu.train"] == pytest.approx(100 * flops / 989e12)
    assert read["optimizer_ms.train"] == pytest.approx(50.0)
    assert read["dispatch_gemm_ms.train"] == pytest.approx(50.0)
    assert read["expert_gemm_ms.train"] == pytest.approx(50.0)
    assert read["idle_share.train"] == pytest.approx(25.0)
    assert 0 < read["flash_roofline.train"] < 100
    assert 0 < read["adam8_roofline.train"] < 100
    assert common.load_module("metrics", "mfu.serve").read(t) is None


def test_serve_readers():
    cell, cfg = common.workload("mistral-7b.decode-b128")
    t = {"kind": "decode", "config": cfg, "traffic": cell["traffic"],
         "device_kind": "NVIDIA H100 80GB HBM3", "calls": 2,
         "window_s": 20.0, "reading": FakeReading(), "step_launches": 10.0}
    assert common.load_module("metrics", "launches_per_step.serve").read(
        t) == pytest.approx(10.0)
    mfu = common.load_module("metrics", "mfu.serve").read(t)
    assert mfu == pytest.approx(100 * 2 * costs.generate_flops(
        cfg, 128, 512, 256) / 20.0 / 989e12)
    assert common.load_module("metrics", "idle_share.serve").read(
        t) == pytest.approx(25.0)
