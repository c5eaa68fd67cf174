"""The port's spans and counters (``tracing.py``) on the CPU.

With no profiler recording, a span is one shared null context and a
counter does nothing: the steps dispatch the same aten ops as with the
calls taken out.  Under a CPU profiler every span appears with its nesting,
the MoE's spans are entered again by the remat recompute inside
``train.backward``, the counters read what the dispatch tensor says, once a
forward whatever the remat policy, and the numbers the steps and
``generate`` produce are bitwise those of an unprofiled run.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_network_operator_torch import tracing
from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.models import moe as tmoe

B, S = 2, 16
NEW = 4


def _cfg(model, remat=None, capacity_factor=1.25):
    if model == "llama":
        cfg = tllama.LlamaConfig.tiny()
    else:
        cfg = dataclasses.replace(tmoe.MoEConfig.tiny(),
                                  capacity_factor=capacity_factor)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
    return cfg


def _family(model):
    return tllama if model == "llama" else tmoe


def _tokens(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)


def _fresh(model, cfg):
    step, init_all, _ = _family(model).make_train_step(cfg, device="cpu")
    params, state = init_all(torch.Generator().manual_seed(0))
    return step, params, state


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _spans(events):
    """(name, thread, start, end) of the program's spans, by start."""
    names = ("train.", "moe.", "generate.")
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end)
                   for e in events if e.name.startswith(names)),
                  key=lambda s: s[2])


def _inside(inner, outer) -> bool:
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def _parents(spans, name, parent):
    """How many spans ``name`` lie inside some ``parent`` span."""
    outs = [s for s in spans if s[0] == parent]
    return sum(any(_inside(s, o) for o in outs)
               for s in spans if s[0] == name)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _clean_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = tracing.span("train.forward")
    assert first is tracing.span("moe.route") is tracing._NULL
    with first:
        pass


def test_count_off_records_and_calls_nothing():
    def never():
        raise AssertionError("a counter's value was made with tracing off")

    tracing.count("moe.slots_empty", never)
    tracing.count("moe.assignments_dropped", torch.tensor(3))
    assert tracing.counters() == {}


def test_count_under_profiler_sums_once_per_forward():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("n", torch.tensor(2))
        tracing.count("n", lambda: torch.tensor(5))
        x = torch.ones(2, requires_grad=True)

        class Inside(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t * 2

            @staticmethod
            def backward(ctx, g):
                # a backward pass: a recompute here must not count again
                tracing.count("n", torch.tensor(100))
                return g * 2

        Inside.apply(x).sum().backward()
    assert tracing.counters() == {"n": 7}
    tracing.reset_counters()
    assert tracing.counters() == {}


@pytest.mark.parametrize("model,remat", [("llama", None), ("moe", None),
                                         ("moe", "dots")])
def test_off_dispatches_the_ops_of_a_step_without_the_calls(model, remat,
                                                            monkeypatch):
    cfg = _cfg(model, remat)
    tokens = _tokens(cfg)

    def ops():
        step, params, state = _fresh(model, cfg)
        with _Ops() as mode:
            step(params, state, tokens)
        return mode.ops

    with_calls = ops()
    monkeypatch.setattr(tracing, "span",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, value: None)
    assert ops() == with_calls
    assert tracing.counters() == {}


SPAN_CASES = [
    # (model, remat): spans expected inside train.forward / train.backward
    ("llama", None),
    ("moe", None),
    ("moe", "dots"),
    ("moe", "full"),
]
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.mark.parametrize("model,remat", SPAN_CASES)
def test_train_spans_and_their_nesting(model, remat):
    cfg = _cfg(model, remat)
    step, params, state = _fresh(model, cfg)
    _, events = _profiled(lambda: step(params, state, _tokens(cfg)))
    spans = _spans(events)
    phases = [s[0] for s in spans if s[0].startswith("train.")]
    assert phases == ["train.forward", "train.backward", "train.optimizer"]
    if model == "llama":
        assert not [s for s in spans if s[0].startswith("moe.")]
        return
    for name in MOE_SPANS:
        assert _parents(spans, name, "train.forward") == cfg.layers
        # the recompute enters the layer's spans again inside the backward
        # (on the CPU the backward runs on the caller's thread)
        again = _parents(spans, name, "train.backward")
        assert again == (0 if remat is None else cfg.layers), name
    # the regions of a layer follow each other in order, none nested
    forward = [s[0] for s in spans if s[0].startswith("moe.")][:4]
    assert forward == list(MOE_SPANS)
    for a in spans:
        for b in spans:
            if a is not b and a[0].startswith("moe.") \
                    and b[0].startswith("moe."):
                assert not _inside(a, b)


def _generate(cfg, params):
    prompt = _tokens(cfg)[:, :8]
    return tgen.generate(params, prompt, cfg, NEW, decode_block=8)


def test_generate_spans_and_their_nesting():
    cfg = _cfg("llama")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, events = _profiled(lambda: _generate(cfg, params))
    spans = _spans(events)
    assert [s[0] for s in spans if s[0] != "generate.attention"] == \
        ["generate.prefill"] + ["generate.decode_step"] * (NEW - 1)
    attn = [s for s in spans if s[0] == "generate.attention"]
    assert len(attn) == cfg.layers * NEW
    assert _parents(spans, "generate.attention", "generate.prefill") \
        == cfg.layers
    assert _parents(spans, "generate.attention", "generate.decode_step") \
        == cfg.layers * (NEW - 1)


def _routed(monkeypatch):
    """Wrap ``route`` to keep, for each forward call (not a recompute),
    (k * B * S, dispatch.sum(), B * E * C)."""
    seen = []
    route = tmoe.route

    def wrapped(probs, k, capacity):
        dispatch, combine = route(probs, k, capacity)
        if torch._C._current_graph_task_id() == -1:
            b, s, e = probs.shape
            seen.append((k * b * s, int(dispatch.sum()), b * e * capacity))
        return dispatch, combine

    monkeypatch.setattr(tmoe, "route", wrapped)
    return seen


@pytest.mark.parametrize("remat", [None, "dots", "full"])
def test_counters_read_the_dispatch_tensor_once_a_forward(remat,
                                                          monkeypatch):
    # a capacity factor under 1 makes the capacity drop assignments
    cfg = _cfg("moe", remat, capacity_factor=0.5)
    seen = _routed(monkeypatch)
    step, params, state = _fresh("moe", cfg)
    _profiled(lambda: step(params, state, _tokens(cfg)))
    got = tracing.counters()
    assert len(seen) == cfg.layers
    dropped = sum(n - kept for n, kept, _ in seen)
    empty = sum(slots - kept for _, kept, slots in seen)
    assert dropped > 0
    assert got == {"moe.assignments_dropped": dropped,
                   "moe.slots_empty": empty}
    # the identity the benchmark's two shares rest on
    assigned = sum(n for n, _, _ in seen)
    slots = sum(s for _, _, s in seen)
    assert got["moe.slots_empty"] == slots - (assigned - dropped)


def test_counters_agree_across_remat_policies():
    got = {}
    for remat in (None, "dots", "full"):
        tracing.reset_counters()
        cfg = _cfg("moe", remat, capacity_factor=0.5)
        step, params, state = _fresh("moe", cfg)
        _profiled(lambda: step(params, state, _tokens(cfg)))
        got[remat] = tracing.counters()
    assert got[None] == got["dots"] == got["full"]


@pytest.mark.parametrize("model,remat", [("llama", None), ("moe", "dots"),
                                         ("moe", "full")])
def test_train_step_bitwise_with_and_without_profiler(model, remat):
    cfg = _cfg(model, remat)
    tokens = _tokens(cfg)
    runs = []
    for traced in (False, True):
        step, params, state = _fresh(model, cfg)
        run = (lambda: step(params, state, tokens))
        out = _profiled(run)[0] if traced else run()
        runs.append((out[2], params, state))
    (loss_a, p_a, s_a), (loss_b, p_b, s_b) = runs
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(_leaves(p_a), _leaves(p_b)):
        assert torch.equal(a, b)
    # the first moment after one step is (1 - b1) x the gradient
    for a, b in zip(_leaves(s_a["mu"]), _leaves(s_b["mu"])):
        assert torch.equal(a, b)


def _leaves(tree):
    from tpu_network_operator_torch.models.training import tree_leaves

    return list(tree_leaves(tree))


def test_generate_bitwise_with_and_without_profiler():
    cfg = _cfg("llama")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plain = _generate(cfg, params)
    traced, _ = _profiled(lambda: _generate(cfg, params))
    assert torch.equal(plain, traced)
