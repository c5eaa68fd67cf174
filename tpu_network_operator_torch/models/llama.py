"""Llama-3-family transformer in PyTorch.

Counterpart of ``tpu_network_operator/models/llama.py``, forward only (the
training half, with remat and the backward kernels, is a later slice).
The parameter layout is the reference's, so weights move between the two
packages by name: a plain dict whose layer leaves are stacked ``[L, ...]``
and whose projections are ``W[in, out]`` applied as ``x @ W``.  The layers
run in a Python loop over the stacked leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import flash_attention as fa
from ..ops.attention import causal_attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_angles

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    ffn: int = 14_336
    max_seq: int = 8192
    rope_theta: float = 500_000.0
    # Llama-3.1-style rope scaling as a sorted items tuple (hashable);
    # None = plain RoPE.  Read via rope_scaling_dict.
    rope_scaling: Optional[Tuple[Tuple[str, float], ...]] = None
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, float]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @staticmethod
    def rope_scaling_from(params: Optional[Mapping[str, float]]):
        """Normalize a rope-scaling mapping into the hashable stored form."""
        if not params:
            return None
        return tuple(sorted(
            (k, float(v)) for k, v in params.items()
            if isinstance(v, (int, float))
        ))

    def num_params(self) -> int:
        """Exact parameter count (embeddings + untied head included)."""
        per_layer = (
            self.hidden * (self.heads + 2 * self.kv_heads) * self.head_dim
            + self.heads * self.head_dim * self.hidden
            + 3 * self.hidden * self.ffn
            + 2 * self.hidden
        )
        return (
            2 * self.vocab_size * self.hidden
            + self.layers * per_layer
            + self.hidden
        )

    # -- presets ------------------------------------------------------------

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        # Llama-3.2-1B geometry
        return LlamaConfig(
            hidden=2048, layers=16, heads=32, kv_heads=8, ffn=8192
        )

    @staticmethod
    def llama3_3b() -> "LlamaConfig":
        # Llama-3.2-3B geometry
        return LlamaConfig(
            hidden=3072, layers=28, heads=24, kv_heads=8, ffn=8192
        )

    @staticmethod
    def llama3_150m() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32_000, hidden=1024, layers=8, heads=16,
            kv_heads=8, ffn=4096, max_seq=2048,
        )

    @staticmethod
    def tiny(vocab: int = 256) -> "LlamaConfig":
        """Test config: small but structurally identical."""
        return LlamaConfig(
            vocab_size=vocab, hidden=64, layers=2, heads=4, kv_heads=2,
            ffn=128, max_seq=128,
        )


# -- parameters ---------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Params:
    """Stacked-layer parameters, truncated-normal(±3σ)/√fan_in init, drawn
    in f32 from ``generator`` (which must live on ``device``) and cast to
    ``cfg.dtype``.  ``device`` None means CUDA, and raises without it."""
    dev = resolve_device(device)
    h, hd, ffn, n = cfg.hidden, cfg.head_dim, cfg.ffn, cfg.layers

    def init(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": init((cfg.vocab_size, h), h),
        "layers": {
            "wq": init((n, h, cfg.heads * hd), h),
            "wk": init((n, h, cfg.kv_heads * hd), h),
            "wv": init((n, h, cfg.kv_heads * hd), h),
            "wo": init((n, cfg.heads * hd, h), cfg.heads * hd),
            "w_gate": init((n, h, ffn), h),
            "w_up": init((n, h, ffn), h),
            "w_down": init((n, ffn, h), ffn),
            "ln_attn": ones((n, h)),
            "ln_mlp": ones((n, h)),
        },
        "ln_final": ones((h,)),
        "lm_head": init((h, cfg.vocab_size), h),
    }


def _leaf_from_numpy(arr, device: torch.device) -> torch.Tensor:
    # a private writable copy: torch.from_numpy shares memory, and arrays
    # exported by JAX are read-only
    a = np.array(arr, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16: same bits as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Mapping[str, Any], device=None) -> Params:
    """The weight bridge: a nested dict of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)`` of the reference's params) to
    torch tensors on ``device``, bit for bit, bf16 included."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_from_numpy(node, dev)

    return walk(tree)


def params_to(params: Params, device) -> Params:
    """A copy of ``params`` on ``device`` (same tree, same dtypes)."""
    dev = torch.device(device)
    return {
        k: params_to(v, dev) if isinstance(v, Mapping) else v.to(dev)
        for k, v in params.items()
    }


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked layer leaves (views)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


# -- forward ------------------------------------------------------------------


def attention(cfg: LlamaConfig, q, k, v) -> torch.Tensor:
    """Flash (kernel on CUDA, its plain version on CPU) when the shape
    gate passes, plain causal attention otherwise."""
    if fa.supports(q.shape[1], k.shape[1], cfg.head_dim):
        return fa.flash_attention(q, k, v)
    return causal_attention(q, k, v)


def _layer(cfg: LlamaConfig, cos, sin, x, lp) -> torch.Tensor:
    """One transformer block.  x: [B, S, H]; lp: this layer's params."""
    y = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    b, s, _ = y.shape
    q = (y @ lp["wq"]).reshape(b, s, cfg.heads, cfg.head_dim)
    k = (y @ lp["wk"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = (y @ lp["wv"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = attention(cfg, q, k, v)
    x = x + a.reshape(b, s, -1) @ lp["wo"]

    y = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
    gated = torch.nn.functional.silu(y @ lp["w_gate"]) * (y @ lp["w_up"])
    return x + gated @ lp["w_down"]


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: LlamaConfig) -> torch.Tensor:
    """Final-norm hidden states [B, S, hidden]."""
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           scaling=cfg.rope_scaling_dict, device=x.device)
    for i in range(cfg.layers):
        x = _layer(cfg, cos, sin, x, layer_params(params, i))
    return rms_norm(x, params["ln_final"], cfg.rms_eps)


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Logits [B, S, vocab] f32 (a matmul in cfg.dtype, then widened)."""
    x = forward_hidden(params, tokens, cfg)
    return (x @ params["lm_head"]).float()
