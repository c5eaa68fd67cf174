"""The attribution of device time to the program's spans
(``portbench/spans.py``) and the readers of the span metrics, on
synthetic lists of profiler events shaped as ``torch.profiler`` gives them
on the card: host ops and spans on the caller's thread (1) and the autograd
engine's device thread (2), each kernel's launch call a host event with
the kernel's correlation id."""

from __future__ import annotations

import json
import types

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import common, spans
from tpu_network_operator_torch import tracing

BENCH = common.benchmark()
NEW = ("fwd_ms.train", "bwd_ms.train", "optimizer_device_ms.train",
       "route_ms.train", "dispatch_ms.train", "experts_ms.train",
       "tokens_dropped.train", "capacity_empty.train", "prefill_ms.serve",
       "decode_step_ms.serve", "decode_attention_ms.serve",
       "decode_host_ms.serve")


class Trace:
    """Builds an event list: host events by (thread, start, end), kernels
    by their launch."""

    def __init__(self):
        self.events = []
        self.next_id = 1000

    def host(self, name, thread, start, end, seq=-1, fwd_thread=0):
        self.next_id += 1
        self.events.append(types.SimpleNamespace(
            name=name, device_type=DeviceType.CPU, is_async=False,
            is_user_annotation=False, id=self.next_id, thread=thread,
            time_range=types.SimpleNamespace(start=start, end=end),
            sequence_nr=seq, fwd_thread=fwd_thread))
        return self.events[-1]

    def kernel(self, thread, at, start, end, name="k"):
        """A kernel running [start, end) launched at host time ``at``."""
        launch = self.host("cudaLaunchKernel", thread, at, at + 0.5)
        self.events.append(types.SimpleNamespace(
            name=name, device_type=DeviceType.CUDA, is_async=False,
            is_user_annotation=False, id=launch.id, thread=thread,
            time_range=types.SimpleNamespace(start=start, end=end),
            sequence_nr=-1, fwd_thread=0))


def reading(events):
    return types.SimpleNamespace(_events=events)


def train_trace():
    """One step of one MoE layer: a route kernel and an expert GEMM in the
    forward; the GEMM's backward on the device thread; a recomputed route
    kernel there; one optimizer kernel."""
    tr = Trace()
    tr.host("train.forward", 1, 0, 100)
    tr.host("moe.route", 1, 10, 40)
    tr.host("aten::softmax", 1, 12, 20, seq=5)
    tr.kernel(1, 13, 50, 60)
    tr.host("moe.experts", 1, 41, 90)
    tr.host("aten::mm", 1, 42, 50, seq=7)
    tr.kernel(1, 43, 60, 80)
    tr.host("train.backward", 1, 100, 300)
    # the recompute inside a backward node re-enters the route span
    tr.host("autograd::engine::evaluate_function: SoftmaxBackward0", 2,
            150, 200, seq=5, fwd_thread=1)
    tr.host("moe.route", 2, 151, 170)
    tr.host("aten::softmax", 2, 152, 160, seq=2)
    tr.kernel(2, 153, 180, 190)
    tr.host("autograd::engine::evaluate_function: MmBackward0", 2, 200,
            250, seq=7, fwd_thread=1)
    tr.host("aten::mm", 2, 205, 215)
    tr.kernel(2, 206, 220, 260)
    # the node also sets off the recompute of the layer's attention, a
    # forward op under no region: its work is no backward of aten::mm
    tr.host("_FlashAttention", 2, 230, 240, seq=3)
    tr.kernel(2, 231, 260, 270)
    tr.host("train.optimizer", 1, 300, 350)
    tr.host("aten::add_", 1, 305, 310)
    tr.kernel(1, 306, 310, 330)
    return tr.events


def train_t(events, family="moe"):
    _, cfg = common.workload("mixtral-8x7b-l4.train-8k")
    return {"kind": "train", "reading": reading(events), "profiled_steps": 1,
            "config": dict(cfg, family=family),
            "traffic": {"batch": 2, "seq": 8192}}


def test_kernel_goes_to_innermost_span_and_phase():
    a = spans.Attribution(train_trace())
    first = a.work[0]
    assert [r.name for r in first.regions] == ["moe.route"]
    assert first.phase == "train.forward"
    assert [r.name for r in a.work[1].regions] == ["moe.experts"]


def test_backward_op_goes_to_its_forward_ops_span():
    a = spans.Attribution(train_trace())
    recompute, backward = a.work[2], a.work[3]
    # the recompute's own span on the device thread
    assert [r.name for r in recompute.regions] == ["moe.route"]
    assert recompute.regions[0].thread == 2
    # the GEMM's backward: the span of aten::mm (seq 7) on thread 1
    assert [r.name for r in backward.regions] == ["moe.experts"]
    assert backward.regions[0].thread == 1
    # launched on the device thread while the caller waits in the backward
    assert recompute.phase == backward.phase == "train.backward"
    attention = a.work[4]
    assert attention.phase == "train.backward" and not attention.regions
    assert a.work[5].phase == "train.optimizer" and not a.work[5].regions


def test_overlapping_intervals_are_united_not_summed():
    assert spans.union_ms([(0, 10), (5, 20), (30, 40)]) == pytest.approx(
        0.030)
    assert spans.union_ms([]) == 0.0
    tr = Trace()
    tr.host("train.forward", 1, 0, 100)
    tr.host("moe.route", 1, 0, 50)
    tr.kernel(1, 1, 10, 30)
    tr.kernel(1, 2, 20, 40)
    t = train_t(tr.events)
    assert spans.region_ms(t, "moe.route") == pytest.approx(0.030)
    assert spans.phase_ms(t, "train.forward") == pytest.approx(0.030)


def _read(name, t):
    return common.load_module("metrics", name).read(t)


def test_train_readers_on_the_synthetic_step():
    t = train_t(train_trace())
    assert _read("fwd_ms.train", t) == pytest.approx(0.030)   # 50-80
    # 180-190, 220-270
    assert _read("bwd_ms.train", t) == pytest.approx(0.060)
    assert _read("optimizer_device_ms.train", t) == pytest.approx(0.020)
    assert _read("route_ms.train", t) == pytest.approx(0.020)  # 50-60, 180-190
    assert _read("experts_ms.train", t) == pytest.approx(0.060)  # 60-80, 220-260
    assert _read("dispatch_ms.train", t) is None  # no such span here
    assert _read("route_ms.train", train_t(train_trace(), "llama")) is None


def decode_trace():
    """A call: prefill with one attention span, two decode steps of one
    attention span each, a kernel between the steps."""
    tr = Trace()
    tr.host("generate.prefill", 1, 0, 100)
    tr.host("generate.attention", 1, 10, 30)
    tr.kernel(1, 11, 20, 60)
    tr.kernel(1, 40, 60, 90)
    for k, t0 in enumerate((200, 400)):
        tr.host("generate.decode_step", 1, t0, t0 + 50 + 10 * k)
        tr.kernel(1, t0 + 1, t0 + 100, t0 + 110)
        tr.host("generate.attention", 1, t0 + 5, t0 + 20)
        tr.kernel(1, t0 + 6, t0 + 110, t0 + 130 + 20 * k)
    tr.kernel(1, 380, 390, 395)
    return tr.events


def test_decode_readers_on_the_synthetic_call():
    t = {"kind": "decode", "reading": reading(decode_trace())}
    assert _read("prefill_ms.serve", t) == pytest.approx(0.070)
    # steps busy 30 and 50 us
    assert _read("decode_step_ms.serve", t) == pytest.approx(0.040)
    # attention 20 and 40 us over two steps
    assert _read("decode_attention_ms.serve", t) == pytest.approx(0.030)
    # hosts 50 and 60 us
    assert _read("decode_host_ms.serve", t) == pytest.approx(0.055)


@pytest.fixture
def counted():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def test_counter_readers(counted):
    import torch

    t = train_t(train_trace())
    cfg = t["config"]
    assert _read("tokens_dropped.train", t) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("moe.assignments_dropped", torch.tensor(1024))
        tracing.count("moe.slots_empty", torch.tensor(8192 + 1024))
    layers = cfg["num_hidden_layers"]
    dropped = _read("tokens_dropped.train", t)
    # C = 2,560: 40,960 slots a layer for 32,768 assignments
    assert dropped == pytest.approx(100 * 1024 / (32768 * layers))
    assert _read("capacity_empty.train", t) == pytest.approx(
        100 * (8192 + 1024) / (40960 * layers))


@pytest.mark.parametrize("name", NEW)
def test_reader_returns_none_without_its_spans(name, counted):
    tr = Trace()
    tr.host("aten::mm", 1, 0, 10, seq=1)
    tr.kernel(1, 1, 5, 8)
    cell = {"train": "mixtral-8x7b-l4.train-8k",
            "serve": "mistral-7b.decode-b128"}[name.rsplit(".", 1)[1]]
    _, cfg = common.workload(cell)
    t = {"kind": "decode" if name.endswith("serve") else "train",
         "reading": reading(tr.events), "profiled_steps": 2, "config": cfg,
         "traffic": {"batch": 2, "seq": 8192}}
    assert _read(name, t) is None
    assert _read(name, {}) is None


@pytest.mark.parametrize("name", NEW)
def test_new_entries_list_their_cells(name):
    entry = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["workloads"]
    assert entry[0]["source"] == "device_trace"
    assert json.dumps(entry[0])
