"""``decode_graph_share.serve`` on counters made under a profiler: the
share of decode steps that ran as a CUDA graph replay, and None where the
program keeps no such counters."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import common
from tpu_network_operator_torch import tracing

NAME = "decode_graph_share.serve"


@pytest.fixture
def counted():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def _read(t):
    return common.load_module("metrics", NAME).read(t)


def _count(graph=None, eager=None):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in (("generate.graph_steps", graph),
                        ("generate.eager_steps", eager)):
            if n is not None:
                tracing.count(name, torch.tensor(n))


@pytest.mark.parametrize("calls,share", [
    # the cell's two traced calls: 2 new tokens (one eager step), then
    # 2 + 32 (one eager step and 32 replays)
    ([(0, 1), (32, 1)], 100 * 32 / 34),
    ([(0, 5)], 0.0),                    # an eager loop throughout
    ([(9, 0)], 100.0),
])
def test_share_of_replayed_steps(counted, calls, share):
    for graph, eager in calls:
        _count(graph, eager)
    assert _read({"kind": "decode"}) == pytest.approx(share)


def test_none_without_the_counters(counted):
    assert _read({"kind": "decode"}) is None
    _count(eager=0, graph=0)
    assert _read({"kind": "decode"}) is None
    _count(graph=3, eager=1)
    assert _read({"kind": "train"}) is None
    assert _read({}) is None


def test_a_profiled_cpu_call_reads_zero(counted):
    # the program's own counters: a CPU call keeps the eager loop
    from tpu_network_operator_torch.models import generate as tgen
    from tpu_network_operator_torch.models import llama as tllama

    cfg = tllama.LlamaConfig(vocab_size=64, hidden=64, layers=1, heads=1,
                             kv_heads=1, ffn=64, max_seq=32,
                             dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        tgen.generate(params, torch.zeros(1, 4, dtype=torch.long), cfg, 5)
    assert _read({"kind": "decode"}) == 0.0
