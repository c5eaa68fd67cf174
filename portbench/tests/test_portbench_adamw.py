"""``adamw_roofline.train`` and ``adamw_fused_share.train`` on traces and
counters whose numbers are known, and None where there is nothing to
read: another optimizer, the decode cell, a program without kernel 8."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import common
from tpu_network_operator_torch import tracing

ROOFLINE = common.load_module("metrics", "adamw_roofline.train")
SHARE = common.load_module("metrics", "adamw_fused_share.train")
H100 = "NVIDIA H100 80GB HBM3"
CELL = "mistral-7b-l24.train-4k"


class Kernels:
    """A reading whose kernels named ``adamw_fused`` took ``secs``."""

    def __init__(self, secs: float):
        self.secs = secs

    def kernel_s(self, *names):
        return self.secs if "adamw_fused" in names else 0.0


def _trace(secs=0.0, optimizer="adamw", kind="train", cell=CELL):
    wl, cfg = common.workload(cell)
    return {"kind": kind, "config": cfg,
            "traffic": dict(wl["traffic"], optimizer=optimizer),
            "device_kind": H100, "reading": Kernels(secs),
            "profiled_steps": 2,
            # the cell's bf16 leaves, and an f32 one
            "leaves": [(1000, 2), (3000, 2), (500, 4)]}


@pytest.fixture
def counted():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def test_roofline_of_the_update_bytes():
    # 14 bytes a bf16 value and 28 an f32 one, two profiled steps
    nbytes = 4000 * 14 + 500 * 28
    assert ROOFLINE.update_bytes(_trace()["leaves"]) == nbytes
    step = nbytes / 3.35e12
    assert ROOFLINE.read(_trace(2 * step)) == pytest.approx(100.0)
    assert ROOFLINE.read(_trace(4 * step)) == pytest.approx(50.0)


def test_roofline_nothing_to_read():
    assert ROOFLINE.read(_trace(0.0)) is None              # the parent
    assert ROOFLINE.read(_trace(1.0, optimizer="adamw8bit")) is None
    assert ROOFLINE.read(_trace(1.0, kind="decode")) is None
    assert ROOFLINE.read({"kind": "decode"}) is None


def _count(n):
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("optim.adamw_fused_elems", torch.tensor(n))


def test_share_of_the_stepped_values(counted):
    _count(4500)                      # one profiled step of the whole tree
    assert SHARE.read(_trace()) == pytest.approx(50.0)
    _count(4500)
    assert SHARE.read(_trace()) == pytest.approx(100.0)


def test_share_nothing_to_read(counted):
    assert SHARE.read(_trace()) is None                   # no counter
    _count(4500)
    assert SHARE.read(_trace(optimizer="adamw8bit")) is None
    assert SHARE.read({"kind": "decode"}) is None


def test_a_profiled_cpu_step_counts_nothing(counted):
    # CPU leaves take the plain path, which counts no fused values
    from tpu_network_operator_torch.models import training

    params = {"w": torch.ones(4, 8, dtype=torch.bfloat16)}
    opt = training.adamw()
    state = opt.init(params)
    with profile(activities=[ProfilerActivity.CPU]):
        opt.apply(params, [torch.ones(4, 8, dtype=torch.bfloat16)], state)
    assert SHARE.read(_trace()) is None
