"""The decode-attention op's plain version held against the JAX package's
attention on the CPU, and the serving path's route to it.

``decode_attention`` on CPU tensors runs ``_decode_attention_plain`` (the
kernel's blockwise algorithm in plain PyTorch); it reads the filled prefix
of an un-sliced cache, a view into a [L, B, max_len, Hkv, D] buffer whose
slots past the prefix hold NaN, so a read past ``length`` would show.  The
reference is ``tpu_network_operator/ops/attention.py``'s
``causal_attention`` over the prefix, its query at the last position.
Inputs are made with numpy and handed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.ops import attention as jattn
from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.ops import _kernels
from tpu_network_operator_torch.ops import decode_attention as tda

MAX_LEN = 800
# f32: the same f32 products and softmax in another order (online, over
# 64-key tiles), ~1e-6 seen; bf16: the reference rounds its scores to
# bf16 (2^-9 of scores up to ~4) where the plain version keeps them f32,
# and both round o to bf16: one bf16 ulp (7.8e-3) seen at |o| near 1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, b, hkv, r, d, length):
    """q [B, 1, H, D] and the layer-1 caches of a two-layer buffer, NaN
    past ``length``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * r, d)).astype(np.float32)
    k = rng.standard_normal((2, b, MAX_LEN, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, b, MAX_LEN, hkv, d)).astype(np.float32)
    k[:, :, length:] = np.nan
    v[:, :, length:] = np.nan
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 513, 767])
def test_plain_matches_jax_causal_attention(length, r, d, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _inputs(1000 * r + length + d, 2, 2, r, d, length)
    kb, vb = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    before = dict(_kernels.LAUNCHES)
    out = tda.decode_attention(torch.from_numpy(q).to(tdt), kb[1], vb[1],
                               length)
    assert _kernels.LAUNCHES == before       # the plain version launches none
    ref = jattn.causal_attention(
        jnp.asarray(q, jdt), jnp.asarray(k[1, :, :length], jdt),
        jnp.asarray(v[1, :, :length], jdt), q_offset=length - 1)
    assert out.dtype == tdt and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("block_k", [16, 64, 767])
def test_plain_blocking_changes_only_the_order(block_k):
    # the blocks set the online softmax's steps, not the function
    q, k, v = (torch.from_numpy(t) for t in _inputs(5, 2, 2, 4, 128, 767))
    out = tda._decode_attention_plain(q, k[1], v[1], 767, block_k=block_k)
    whole = tda._decode_attention_plain(q, k[1], v[1], 767, block_k=MAX_LEN)
    torch.testing.assert_close(out, whole, rtol=0, atol=1e-5)


def _cfg(hidden=128, heads=2, kv_heads=1):
    """f32 weights; head_dim hidden / heads."""
    return tllama.LlamaConfig(vocab_size=256, hidden=hidden, layers=2,
                              heads=heads, kv_heads=kv_heads, ffn=256,
                              max_seq=256, dtype=torch.float32)


def _params(cfg):
    return tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompt(b=2, s=8):
    return torch.randint(0, 256, (b, s),
                         generator=torch.Generator().manual_seed(1))


@pytest.fixture
def routes(monkeypatch):
    """The attention calls ``_block_with_cache`` makes, by route."""
    calls = {"decode": [], "causal": [], "flash": []}
    real = {"decode": tgen.decode_attention, "causal": tgen.causal_attention,
            "flash": tgen.flash_attention}

    def record(name):
        def fn(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return fn

    monkeypatch.setattr(tgen, "decode_attention", record("decode"))
    monkeypatch.setattr(tgen, "causal_attention", record("causal"))
    monkeypatch.setattr(tgen, "flash_attention", record("flash"))
    return calls


def test_decode_steps_take_the_decode_route(routes):
    # 8-token prompt (causal prefill), 5 decode steps of 2 layers, each
    # reading the whole cache buffer up to the filled prefix
    cfg = _cfg()
    tgen.generate(_params(cfg), _prompt(), cfg, 6, max_len=40,
                  decode_block=16)
    assert len(routes["causal"]) == cfg.layers and not routes["flash"]
    assert len(routes["decode"]) == 5 * cfg.layers
    lengths = [args[3] for args, _ in routes["decode"]]
    assert lengths == [p for p in range(9, 14) for _ in range(cfg.layers)]
    for (q, kc, vc, _), _ in routes["decode"]:
        assert q.shape == (2, 1, 2, 64)
        assert kc.shape == vc.shape == (2, 40, 1, 64)


def test_flash_prefill_then_decode_route(routes):
    cfg = _cfg()
    tgen.generate(_params(cfg), _prompt(s=128), cfg, 3)
    assert len(routes["flash"]) == cfg.layers and not routes["causal"]
    assert len(routes["decode"]) == 2 * cfg.layers


def test_int8_cache_keeps_causal_attention(routes):
    cfg = _cfg()
    tgen.generate(_params(cfg), _prompt(), cfg, 4, kv_dtype="int8")
    assert not routes["decode"]
    assert len(routes["causal"]) == 4 * cfg.layers


def test_head_dim_96_keeps_causal_attention(routes):
    cfg = _cfg(hidden=192)
    assert cfg.head_dim == 96
    tgen.generate(_params(cfg), _prompt(), cfg, 4)
    assert not routes["decode"]
    assert len(routes["causal"]) == 4 * cfg.layers


def test_several_new_tokens_keep_causal_attention(routes):
    # s > 1 past position 0 (a chunk after a prefill): the plain route
    cfg = _cfg()
    params = _params(cfg)
    cache = tgen.init_cache(cfg, 2, 32, device="cpu")
    toks = _prompt(s=11)
    tgen.forward_with_cache(params, toks[:, :8], cache, 0, cfg)
    tgen.forward_with_cache(params, toks[:, 8:], cache, 8, cfg)
    assert not routes["decode"]
    assert len(routes["causal"]) == 2 * cfg.layers


@pytest.mark.parametrize("r", [1, 4])
def test_decode_route_matches_the_plain_route(monkeypatch, r):
    # a decode step's logits through the decode op and through the
    # grouped einsum over the attn_len view agree to f32 order
    cfg = _cfg(hidden=256, heads=4 if r == 4 else 2, kv_heads=1 if r == 4
               else 2)
    assert cfg.head_dim in (64, 128)
    params, toks = _params(cfg), _prompt(s=9)
    out = {}
    for route in (True, False):
        monkeypatch.setattr(tgen, "_decode_kernel_ok",
                            lambda c, s, qz, route=route: route and s == 1)
        cache = tgen.init_cache(cfg, 2, 24, device="cpu")
        tgen.forward_with_cache(params, toks[:, :8], cache, 0, cfg)
        out[route], _ = tgen.forward_with_cache(params, toks[:, 8:], cache, 8,
                                                cfg, attn_len=16)
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-5)


def test_route_rule():
    ok = tgen._decode_kernel_ok
    assert ok(_cfg(), 1, False)                       # D 64
    assert ok(_cfg(hidden=256), 1, False)             # D 128
    assert not ok(_cfg(), 2, False)
    assert not ok(_cfg(), 1, True)
    assert not ok(_cfg(hidden=192), 1, False)         # D 96
    assert not ok(dataclasses.replace(_cfg(), hidden=512), 1, False)  # D 256


def test_refusals():
    q = torch.zeros(2, 1, 4, 64)
    kc = torch.zeros(2, 16, 2, 64)
    with pytest.raises(ValueError, match=r"\[B, 1, H, D\]"):
        tda.decode_attention(torch.zeros(2, 2, 4, 64), kc, kc, 3)
    with pytest.raises(ValueError, match="head_dim in"):
        tda.decode_attention(torch.zeros(2, 1, 4, 96),
                             torch.zeros(2, 16, 2, 96),
                             torch.zeros(2, 16, 2, 96), 3)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tda.decode_attention(torch.zeros(2, 1, 3, 64), kc, kc, 3)
    for length in (0, 17):
        with pytest.raises(ValueError, match="length must be in"):
            tda.decode_attention(q, kc, kc, length)
    with pytest.raises(ValueError, match="one \\[B, max_len, Hkv, D\\] shape"):
        tda.decode_attention(q, kc, torch.zeros(2, 15, 2, 64), 3)
    with pytest.raises(ValueError, match="batch or head_dim"):
        tda.decode_attention(torch.zeros(3, 1, 4, 64), kc, kc, 3)
    assert tda.decode_attention(q, kc, kc, 16).shape == q.shape


@pytest.mark.parametrize("blocks,length,d,splits", [
    (1024, 640, 128, 1),   # the benchmark cell's 128 rows x 8 kv-heads
    (512, 384, 64, 1),     # llama3-1b's serving batch of 64
    (64, 8192, 128, 1),    # 8 rows x 8 kv-heads reach the bandwidth
    (32, 768, 128, 1),     # 4 rows: 3 parts would save 512 keys, no more
    (32, 2048, 128, 3),
    (16, 768, 128, 4),
    (8, 512, 128, 1),      # 8 tiles: splitting saves at most 448 keys
    (8, 8192, 128, 9),     # one row at 8k: 66 blocks
    (8, 8192, 64, 16),     # head_dim 64 keeps half the bytes in flight
    (64, 768, 64, 1),
    (64, 2048, 64, 3),
    (16, 1, 64, 1),
])
def test_split_plan(blocks, length, d, splits):
    # the rule measured on an H100 (PERF.md, kernel 7): parts of whole
    # tiles, none empty, that bring the blocks to about 132 x 64 / D
    sms = 132
    tiles = -(-length // tda.DECODE_TILE)
    got, per = tda.split_plan(blocks, length, sms, d)
    assert got == splits
    assert per >= 1 and (got - 1) * per < tiles <= got * per
    if got > 1:
        assert tiles - per > 512 // tda.DECODE_TILE


@pytest.mark.parametrize("length", [1, 63, 64, 65, MAX_LEN])
def test_tensor_length_is_the_int_length(length):
    # the length a captured step reads from a buffer: the same keys
    q, k, v = (torch.from_numpy(t) for t in _inputs(7, 2, 2, 4, 64, length))
    out = tda.decode_attention(q, k[1], v[1], torch.tensor([length]))
    assert torch.equal(out, tda.decode_attention(q, k[1], v[1], length))


def test_tensor_length_refusals():
    q, kc = torch.zeros(2, 1, 4, 64), torch.zeros(2, 16, 2, 64)
    for bad in (torch.tensor([3], dtype=torch.int32), torch.tensor([3, 4]),
                torch.tensor(3.0)):
        with pytest.raises(ValueError, match="a tensor length must be"):
            tda.decode_attention(q, kc, kc, bad)


def test_kernel_is_registered():
    assert _kernels.LAUNCHES["decode_attn"] >= 0
    assert len(_kernels._SIGNATURES["tpunet_decode_attn"]) == 27
