"""The port's Llama model held against the JAX package's, on the CPU.

Parameters are made once by the JAX package and moved across with
``params_from_jax``; tokens are made with numpy.  The JAX side runs its
Pallas kernels (flash forward, fused RMSNorm) in interpret mode, routed
there through the same seams its own suite uses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.models import llama as jllama
from tpu_network_operator_torch.models import llama as tllama

PRESETS = ["tiny", "llama3_150m", "llama3_1b", "llama3_3b", "llama3_8b"]


def torch_cfg(jcfg):
    """The port's config with the reference config's fields."""
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items()
          if k in fields and k != "dtype"}
    dtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    return tllama.LlamaConfig(**kw, dtype=dtype[jcfg.dtype])


def jax_params_np(jcfg, seed):
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed),
                                                       jcfg))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match(name):
    jcfg = getattr(jllama.LlamaConfig, name)()
    tcfg = getattr(tllama.LlamaConfig, name)()
    assert tcfg == torch_cfg(jcfg)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.head_dim == jcfg.head_dim


def test_llama3_1b_geometry():
    cfg = tllama.LlamaConfig.llama3_1b()
    assert (cfg.hidden, cfg.layers, cfg.heads, cfg.kv_heads, cfg.head_dim,
            cfg.ffn, cfg.vocab_size) == (2048, 16, 32, 8, 64, 8192, 128_256)
    assert 1.45e9 < cfg.num_params() < 1.55e9


def test_rope_scaling_roundtrip():
    raw = {"factor": 8.0, "rope_type": "llama3", "low_freq_factor": 1}
    assert tllama.LlamaConfig.rope_scaling_from(raw) == \
        jllama.LlamaConfig.rope_scaling_from(raw)
    cfg = tllama.LlamaConfig(
        rope_scaling=tllama.LlamaConfig.rope_scaling_from(raw))
    assert cfg.rope_scaling_dict == {"factor": 8.0, "low_freq_factor": 1.0}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_bit_exact(dtype):
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(),
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tree = jax_params_np(jcfg, 0)
    params = tllama.params_from_jax(tree, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == getattr(torch, dtype)
        assert tuple(node.shape) == leaf.shape
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        tbits = torch.int16 if dtype == "bfloat16" else torch.int32
        np.testing.assert_array_equal(
            node.view(tbits).numpy().view(bits), leaf.view(bits))


def test_init_params_layout_and_determinism():
    cfg = tllama.LlamaConfig.tiny()
    a = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ref = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda: jllama.init_params(jax.random.key(0),
                                   jllama.LlamaConfig.tiny())))
    for name, leaf in a["layers"].items():
        assert tuple(leaf.shape) == ref["layers"][name]
        assert torch.equal(leaf, b["layers"][name])
    assert tuple(a["embed"].shape) == ref["embed"]
    assert tuple(a["lm_head"].shape) == ref["lm_head"]
    w = a["layers"]["wq"].float()
    # truncated normal / sqrt(fan_in): |w| <= 3 / sqrt(hidden)
    assert w.abs().max() <= 3.0 / cfg.hidden ** 0.5 + 1e-6
    assert a["embed"].dtype == torch.bfloat16


def flash_cfg(dtype):
    """head_dim 64 and 128-token sequences: the flash gate passes on both
    sides, and 256 rows x hidden 128 pass the fused-RMSNorm gate."""
    return jllama.LlamaConfig(
        vocab_size=256, hidden=128, layers=2, heads=2, kv_heads=1, ffn=256,
        max_seq=256, remat=False, dtype=dtype)


@pytest.fixture
def jax_kernels(monkeypatch):
    """Route the JAX model through both Pallas kernels (interpret mode)."""
    monkeypatch.setattr(jllama, "_backend", lambda: "tpu", raising=True)
    monkeypatch.setenv("TPUNET_RMS_FUSED", "1")


@pytest.mark.parametrize("dtype,atol", [
    # f32 activations: both sides round only where the flash kernel does
    # (q*scale, p to bf16); a 1-ulp flip of one bf16 p (2^-8 relative) in
    # layer 0 carries through layer 1 to a few 1e-3 on a handful of logits
    ("float32", 6e-3),
    # bf16: every matmul output is rounded; a 2-layer stack compounds a
    # few bf16 ulps into logits of magnitude ~1
    ("bfloat16", 6e-2),
])
def test_forward_logits_match_flash_route(jax_kernels, dtype, atol):
    jcfg = flash_cfg(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tree = jax_params_np(jcfg, 1)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 128),
                                               dtype=np.int32)
    ref = np.asarray(jllama.forward(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(tokens), jcfg))
    tcfg = torch_cfg(jcfg)
    out = tllama.forward(tllama.params_from_jax(tree, "cpu"),
                         torch.from_numpy(tokens).long(), tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 128, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)


def test_forward_logits_match_plain_route():
    # tiny preset: head_dim 16 fails the flash gate on both sides, so
    # plain attention; f32 summation order only
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tree = jax_params_np(jcfg, 4)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 12),
                                               dtype=np.int32)
    ref = np.asarray(jllama.forward(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(tokens), jcfg))
    out = tllama.forward(tllama.params_from_jax(tree, "cpu"),
                         torch.from_numpy(tokens).long(), torch_cfg(jcfg))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_attention_routes_by_gate(monkeypatch):
    from tpu_network_operator_torch.ops import flash_attention as tfa

    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = torch_cfg(flash_cfg(jnp.float32))
    q = torch.zeros(1, 128, 2, 64)
    k = torch.zeros(1, 128, 1, 64)
    tllama.attention(cfg, q, k, k)
    assert calls == [1]
    tllama.attention(cfg, q[:, :96], k[:, :96], k[:, :96])   # 96: no gate
    assert calls == [1]


@pytest.mark.parametrize("head_dim", [64, 128, 192, 256])
def test_flash_route_takes_only_kernel_head_dims(head_dim):
    # the reference's gate admits every multiple of 64; the CUDA kernels
    # are built for D 64 and 128, so the port routes the others to plain
    # attention, on the CPU as on the card
    from tpu_network_operator_torch.ops import flash_attention as tfa

    assert tfa.supports(128, 128, head_dim)
    assert tfa.use_flash(128, 128, head_dim) == (head_dim in (64, 128))


def test_head_dim_192_takes_plain_attention(monkeypatch):
    # head_dim 192 at seq 128: the shape gate passes, the kernels have no
    # D 192, so the model takes plain causal attention (flash would raise
    # here) and matches the JAX model, which takes plain attention off the
    # TPU; f32 summation order only, as the plain-route test
    from tpu_network_operator_torch.ops import flash_attention as tfa

    def refuse(*args, **kwargs):
        raise AssertionError("head_dim 192 reached flash attention")

    monkeypatch.setattr(tfa, "flash_attention", refuse)
    jcfg = jllama.LlamaConfig(
        vocab_size=256, hidden=384, layers=2, heads=2, kv_heads=1, ffn=512,
        max_seq=256, remat=False, dtype=jnp.float32)
    assert jcfg.head_dim == 192
    tree = jax_params_np(jcfg, 6)
    tokens = np.random.default_rng(7).integers(0, 256, (2, 128),
                                               dtype=np.int32)
    ref = np.asarray(jllama.forward(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(tokens), jcfg))
    out = tllama.forward(tllama.params_from_jax(tree, "cpu"),
                         torch.from_numpy(tokens).long(), torch_cfg(jcfg))
    assert out.dtype == torch.float32 and out.shape == (2, 128, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
