"""The port's KV-cache serving path held against the JAX package's, on the
CPU.

Parameters come from the JAX package through ``params_from_jax``; prompts
are made with numpy.  Where the JAX side is asked for its kernels, it runs
them in interpret mode (flash prefill, fused RMSNorm), switched on the
way its own suite switches them.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.models import generate as jgen
from tpu_network_operator.models import llama as jllama
from test_torch_llama import flash_cfg, torch_cfg
from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.workload import cli


def both_params(jcfg, seed):
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    return jp, tllama.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def prompt_np(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX side through both Pallas kernels in interpret mode: the
    env switches, plus the single-device view its flash gate requires
    (the suite runs 8 virtual CPU devices)."""
    monkeypatch.setenv("TPUNET_DECODE_FLASH", "1")
    monkeypatch.setenv("TPUNET_RMS_FUSED", "1")
    monkeypatch.setattr(jax, "device_count", lambda backend=None: 1)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jp, tp = both_params(jcfg, 0)
    return jcfg, torch_cfg(jcfg), jp, tp


@pytest.mark.parametrize("dtype,atol", [
    # f32: the only roundings are the flash kernel's bf16 q*scale and p,
    # mirrored on both sides; a flipped p rounding carries to ~1e-3
    ("float32", 6e-3),
    # bf16: every product output rounded, compounding over two layers
    ("bfloat16", 6e-2),
])
def test_prefill_logits_match_jax_kernels(jax_kernels, dtype, atol):
    jcfg = flash_cfg(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    jp, tp = both_params(jcfg, 1)
    prompt = prompt_np(2, 2, 128)
    ref, _ = jgen.forward_with_cache(jp, jnp.asarray(prompt),
                                     jgen.init_cache(jcfg, 2, 136), 0, jcfg,
                                     attn_len=128)
    tcfg = torch_cfg(jcfg)
    cache = tgen.init_cache(tcfg, 2, 136, device="cpu")
    out, cache2 = tgen.forward_with_cache(
        tp, torch.from_numpy(prompt).long(), cache, 0, tcfg, attn_len=128)
    assert cache2 is cache
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_greedy_generate_matches_jax_kernels(jax_kernels, monkeypatch):
    # f32 weights: logits agree to ~1e-3 (previous test), well inside the
    # top-1 margins of this seed, so greedy tokens must be equal
    jcfg = flash_cfg(jnp.float32)
    jp, tp = both_params(jcfg, 3)
    prompt = prompt_np(4, 2, 128)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tgen, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ref = jax.jit(lambda p, t: jgen.generate(p, t, jcfg, 6))(
        jp, jnp.asarray(prompt))
    out = tgen.generate(tp, torch.from_numpy(prompt), torch_cfg(jcfg), 6)
    assert calls == [1] * jcfg.layers        # prefill only, every layer
    assert out.dtype == torch.int32 and out.shape == (2, 134)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_segmented_decode_matches_full_buffer_and_jax(tiny_pair):
    # segments of 4 cross several prefix lengths; truncating the masked
    # tail is a pure work reduction, so tokens are identical
    jcfg, tcfg, jp, tp = tiny_pair
    prompt = prompt_np(11, 2, 5)
    full = tgen.generate(tp, torch.from_numpy(prompt), tcfg, 17, max_len=64,
                         decode_block=0)
    seg = tgen.generate(tp, torch.from_numpy(prompt), tcfg, 17, max_len=64,
                        decode_block=4)
    np.testing.assert_array_equal(full.numpy(), seg.numpy())
    ref = jax.jit(lambda p, t: jgen.generate(p, t, jcfg, 17, max_len=64,
                                             decode_block=4))(
        jp, jnp.asarray(prompt))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(ref))


def test_incremental_decode_matches_prefill(tiny_pair):
    # one token at a time through the cache reproduces the all-at-once
    # logits (f32: summation order only)
    _, tcfg, _, tp = tiny_pair
    toks = torch.from_numpy(prompt_np(2, 1, 8)).long()
    full, _ = tgen.forward_with_cache(
        tp, toks, tgen.init_cache(tcfg, 1, 8, device="cpu"), 0, tcfg)
    cache = tgen.init_cache(tcfg, 1, 8, device="cpu")
    steps = []
    for i in range(8):
        lg, cache = tgen.forward_with_cache(tp, toks[:, i:i + 1], cache, i,
                                            tcfg)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=1e-5)


def test_quant_rows_bit_exact():
    x = (np.random.default_rng(6).standard_normal((2, 3, 2, 16)) * 3).astype(
        np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row keeps scale 1
    jq, js = jgen._quant_rows(jnp.asarray(x))
    tq, ts = tgen._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tgen._dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jgen._dequant(jq, js, jnp.float32)))


def test_int8_cache_matches_jax(tiny_pair, monkeypatch):
    # the JAX int8 path (causal route, as its suite pins it) against the
    # port's: same quantizer bits, then f32 summation order only
    monkeypatch.setenv("TPUNET_DECODE_FLASH", "0")
    jcfg, tcfg, jp, tp = tiny_pair
    prompt = prompt_np(7, 2, 6)
    jc = jgen.init_cache(jcfg, 2, 12, "int8")
    tc = tgen.init_cache(tcfg, 2, 12, "int8", device="cpu")
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].shape == tc["k"].shape[:-1]
    ref, jc = jgen.forward_with_cache(jp, jnp.asarray(prompt), jc, 0, jcfg,
                                      attn_len=6)
    out, tc = tgen.forward_with_cache(tp, torch.from_numpy(prompt).long(),
                                      tc, 0, tcfg, attn_len=6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    tok = np.asarray(jnp.argmax(ref[:, -1], -1)).astype(np.int32)
    assert np.array_equal(tok, out[:, -1].argmax(-1).numpy())
    ref, jc = jgen.forward_with_cache(jp, jnp.asarray(tok)[:, None], jc, 6,
                                      jcfg, attn_len=7)
    out, tc = tgen.forward_with_cache(tp, torch.from_numpy(tok)[:, None].long(),
                                      tc, 6, tcfg, attn_len=7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    # the written rows quantize identically up to f32 rounding of k itself
    assert (tc["k"].numpy() != np.asarray(jc["k"])).mean() < 0.01


def test_int8_generate_end_to_end(tiny_pair):
    _, tcfg, _, tp = tiny_pair
    prompt = torch.from_numpy(prompt_np(3, 2, 8))
    out = {kd: tgen.generate(tp, prompt, tcfg, 16, kv_dtype=kd)
           for kd in ("native", "int8")}
    assert out["int8"].shape == out["native"].shape == (2, 24)
    assert (out["int8"] == out["native"]).float().mean() > 0.6
    with pytest.raises(ValueError, match="kv_dtype"):
        tgen.init_cache(tcfg, 1, 4, "fp8", device="cpu")


def _truncation_ref(logits, top_k, top_p):
    """numpy transcription of the reference's truncation rule."""
    lg = logits.astype(np.float64)
    if 0 < top_k < lg.shape[-1]:
        kth = np.sort(lg, -1)[:, ::-1][:, top_k - 1:top_k]
        lg = np.where(lg < kth, -np.inf, lg)
    if 0.0 < top_p < 1.0:
        srt = np.sort(lg, -1)[:, ::-1]
        e = np.exp(srt - srt[:, :1])
        probs = e / e.sum(-1, keepdims=True)
        keep = np.cumsum(probs, -1) - probs < top_p
        cutoff = np.take_along_axis(srt, keep.sum(-1, keepdims=True) - 1, -1)
        lg = np.where(lg < cutoff, -np.inf, lg)
    return np.isfinite(lg)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.5), (20, 0.8),
                                         (0, 1.0)])
def test_sampling_support_matches_jax(top_k, top_p):
    # draws differ by construction (jax.random vs torch.Generator); what
    # must agree is which ids keep non-zero probability
    logits = np.random.default_rng(8).standard_normal((3, 64)).astype(
        np.float32) * 3
    support = tgen._truncate(torch.from_numpy(logits), top_k, top_p)
    support = torch.isfinite(support).numpy()
    np.testing.assert_array_equal(support, _truncation_ref(logits, top_k,
                                                           top_p))
    keys = jax.random.split(jax.random.key(0), 200)
    jdraws = np.asarray(jax.vmap(lambda k: jgen._sample(
        jnp.asarray(logits), 1.0, k, top_k, top_p))(keys))      # [200, 3]
    gen = torch.Generator().manual_seed(0)
    tdraws = np.stack([tgen._sample(torch.from_numpy(logits), 1.0, gen,
                                    top_k, top_p).numpy()
                       for _ in range(200)])
    for draws in (jdraws, tdraws):
        for row in range(3):
            assert support[row, draws[:, row]].all()
    if top_k == 5:
        # every one of the 5 kept ids shows up in 200 draws on both sides
        for draws in (jdraws, tdraws):
            assert len(np.unique(draws[:, 0])) > 1


def test_sample_greedy_and_validation():
    logits = torch.tensor([[0.1, 2.0, 2.0, -1.0]])
    assert tgen._sample(logits, 0.0, None).tolist() == [1]   # first max
    with pytest.raises(ValueError, match="top_p"):
        tgen._sample(logits, 1.0, None, top_p=0.0)


def test_sampled_generate_seeded(tiny_pair):
    _, tcfg, _, tp = tiny_pair
    prompt = torch.from_numpy(prompt_np(9, 2, 4))
    fn = tgen.make_generate_fn(tcfg, 10, temperature=0.8, top_k=16,
                               top_p=0.9)
    a = fn(tp, prompt, torch.Generator().manual_seed(5))
    b = fn(tp, prompt, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (2, 14)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_cli_generate_cpu(capsys):
    assert cli.main(["generate", "--device", "cpu", "--preset", "tiny",
                     "--batch", "2", "--prompt-len", "8",
                     "--max-new-tokens", "5"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    row = json.loads(line)
    assert row["metric"] == "tiny decode throughput"
    assert row["unit"] == "tokens/sec" and row["value"] > 0
    assert row["out_shape"] == [2, 13]
    assert {"batch", "new_tokens", "kv_dtype", "mesh"} <= set(row)


# -- the CUDA-graph route's rule, its fallbacks and its step, on the CPU -----


def _small(hidden=128):
    """f32, 2 layers, one kv-head; head_dim hidden / 2 (64, 128 or 96)."""
    return tllama.LlamaConfig(vocab_size=256, hidden=hidden, layers=2,
                              heads=2, kv_heads=1, ffn=256, max_seq=256,
                              dtype=torch.float32)


def _small_run(cfg, **kw):
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    return params, prompt, tgen.generate(params, prompt, cfg, 12, max_len=40,
                                         **kw)


# the new tokens the eager loop gave before the graph route existed
STORED_TOKENS = {
    (128, "native"): [[110, 110, 233, 97, 162, 112, 222, 206, 126, 222, 214,
                       214],
                      [186, 30, 148, 30, 30, 30, 30, 40, 180, 30, 40, 219]],
    (256, "native"): [[67, 67, 67, 67, 122, 37, 87, 117, 91, 57, 81, 7],
                      [221, 29, 29, 235, 29, 146, 43, 100, 6, 29, 83, 146]],
    (128, "int8"): [[110, 110, 233, 97, 162, 140, 87, 29, 233, 233, 222, 206],
                    [186, 30, 148, 30, 30, 30, 30, 40, 180, 30, 40, 219]],
    (192, "native"): [[137, 137, 86, 91, 86, 86, 86, 86, 86, 86, 86, 86],
                      [77, 34, 165, 34, 165, 227, 139, 204, 87, 139, 204,
                       98]],
}


@pytest.mark.parametrize("hidden,kv_dtype,decode_block", [
    (128, "native", 256), (128, "native", 4), (256, "native", 256),
    (128, "int8", 256), (192, "native", 4)])
def test_cpu_greedy_tokens_are_the_stored_ones(hidden, kv_dtype,
                                               decode_block):
    _, prompt, out = _small_run(_small(hidden), kv_dtype=kv_dtype,
                                decode_block=decode_block)
    assert out.dtype == torch.int32 and torch.equal(out[:, :8].long(), prompt)
    assert out[:, 8:].tolist() == STORED_TOKENS[(hidden, kv_dtype)]


def _counted(fn):
    from torch.profiler import ProfilerActivity, profile

    from tpu_network_operator_torch import tracing

    tracing.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return tracing.counters()
    finally:
        tracing.reset_counters()


@pytest.mark.parametrize("hidden,kw", [
    (128, {}),                                   # the CPU
    (128, {"kv_dtype": "int8"}),
    (192, {}),                                   # head_dim 96
    (128, {"temperature": 0.7, "generator": torch.Generator()}),
])
def test_fallbacks_count_eager_steps(hidden, kw):
    got = _counted(lambda: _small_run(_small(hidden), **kw))
    assert got == {"generate.eager_steps": 11, "generate.graph_steps": 0}


def test_counters_only_under_a_profiler():
    from tpu_network_operator_torch import tracing

    tracing.reset_counters()
    _small_run(_small())
    assert tracing.counters() == {}


@pytest.mark.parametrize("change", [None, "cpu", "mesh", "int8",
                                    "head_dim_96", "sampled"])
def test_graph_rule(change):
    # each condition alone sends a call to the eager loop
    args = dict(cfg=_small(), device=torch.device("cuda"), mesh=None,
                kv_dtype="native", temperature=0.0)
    args.update({None: {}, "cpu": {"device": torch.device("cpu")},
                 "mesh": {"mesh": object()}, "int8": {"kv_dtype": "int8"},
                 "head_dim_96": {"cfg": _small(192)},
                 "sampled": {"temperature": 0.5}}[change])
    assert tgen._graph_ok(**args) == (change is None)


@pytest.mark.parametrize("hidden", [128, 256])
def test_device_position_step_gives_the_eager_tokens(hidden):
    # the graph route's step (position and token in buffers, the cache
    # row written by index, the length read from a tensor), called
    # eagerly, against the eager loop
    cfg = _small(hidden)
    params, prompt, want = _small_run(cfg)
    cache = tgen.init_cache(cfg, 2, 40, device="cpu")
    rope = tllama.rope_tables(cfg, 40, "cpu")[0]

    def forward(tokens, pos, attn_len=None):
        return tgen.forward_with_cache(params, tokens, cache, pos, cfg,
                                       attn_len, rope)[0]

    out = torch.full((2, 20), -1, dtype=torch.int32)
    out[:, :8] = prompt
    out[:, 8] = tgen._sample(forward(prompt.long(), 0, 8)[:, -1], 0.0, None)
    step = tgen._DecodeStep(forward, out, 8)
    for _ in range(11):
        step()
    assert torch.equal(out, want)
    assert step.pos.tolist() == [19] and step.tok[:, 0].tolist() == \
        want[:, 19].tolist()


def test_device_position_refusals():
    pos = torch.tensor([8])
    for cfg, kv, s in ((_small(), "int8", 1), (_small(192), "native", 1),
                       (_small(), "native", 2)):
        params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        cache = tgen.init_cache(cfg, 1, 16, kv, device="cpu")
        with pytest.raises(ValueError, match="a device position takes"):
            tgen.forward_with_cache(params, torch.zeros(1, s).long(), cache,
                                    pos, cfg)
