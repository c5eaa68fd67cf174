"""Llama-3-family transformer in PyTorch.

Counterpart of ``tpu_network_operator/models/llama.py`` on one device:
the forward, the training loss (full or chunked cross entropy) with the
layers under the configured remat policy, and the train step.  The
parameter layout is the reference's, so weights move between the two
packages by name: a plain dict whose layer leaves are stacked ``[L, ...]``
and whose projections are ``W[in, out]`` applied as ``x @ W``.  The layers
run in a Python loop over the stacked leaves, unbound once per forward.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import flash_attention as fa
from ..ops.attention import causal_attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_angles
from . import training

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
    remat: bool = True
    # training.remat's policy names: "dots", "ffn", "ffn_lite",
    # "ffn_offload", "full"
    remat_policy: str = "dots"
    # >0: training cross entropy in sequence chunks of this size, so the
    # [B, S, vocab] logits are never held at once
    # (training.chunked_next_token_xent); 0 = full logits
    xent_chunk: int = 0

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
            ffn=128, max_seq=128, remat=False,
        )


# -- parameters ---------------------------------------------------------------


def init_weight(shape, fan_in: int, dtype: torch.dtype,
                generator: torch.Generator, device) -> torch.Tensor:
    """A weight drawn truncated-normal(±3σ) in f32 from ``generator``,
    scaled by 1/√fan_in and cast to ``dtype`` (the reference's init)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Params:
    """Stacked-layer parameters, truncated-normal(±3σ)/√fan_in init, drawn
    in f32 from ``generator`` (which must live on ``device``) and cast to
    ``cfg.dtype``.  ``device`` None means CUDA, and raises without it."""
    dev = resolve_device(device)
    h, hd, ffn, n = cfg.hidden, cfg.head_dim, cfg.ffn, cfg.layers

    def init(shape, fan_in):
        return init_weight(shape, fan_in, cfg.dtype, generator, dev)

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


def unbind_layers(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Every layer's slice of the stacked leaves, from one ``unbind`` per
    leaf: its backward is one stack of the layer gradients, where indexing
    each layer would write a zero-filled full-size gradient per layer."""
    names = list(params["layers"])
    slices = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, per_layer)) for per_layer in zip(*slices)]


# -- forward ------------------------------------------------------------------


def attention(cfg: LlamaConfig, q, k, v) -> torch.Tensor:
    """Flash (kernel on CUDA, its plain version on CPU) where
    :func:`..ops.flash_attention.use_flash` routes the shape to it, plain
    causal attention otherwise."""
    if fa.use_flash(q.shape[1], k.shape[1], cfg.head_dim):
        return fa.flash_attention(q, k, v)
    return causal_attention(q, k, v)


def _attn_half(cfg: LlamaConfig, cos, sin, x, lp) -> torch.Tensor:
    """The attention half of a block: the post-attention residual
    (the reference's ``resid_mid``).  x: [B, S, H]."""
    y = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    b, s, _ = y.shape
    q = (y @ lp["wq"]).reshape(b, s, cfg.heads, cfg.head_dim)
    k = (y @ lp["wk"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = (y @ lp["wv"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = attention(cfg, q, k, v)
    return x + a.reshape(b, s, -1) @ lp["wo"]


def _layer(cfg: LlamaConfig, cos, sin, x, lp) -> torch.Tensor:
    """One transformer block.  x: [B, S, H]; lp: this layer's params."""
    x = _attn_half(cfg, cos, sin, x, lp)
    y = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
    gate = y @ lp["w_gate"]
    up = y @ lp["w_up"]
    return x + (torch.nn.functional.silu(gate) * up) @ lp["w_down"]


def _remat_block(cfg: LlamaConfig, cos, sin):
    """A block under ``cfg.remat_policy``.  "ffn" / "ffn_lite" keep the
    reference's named tensors: the attention half is recomputed from the
    block's input, and the FFN half saves its input (``resid_mid``) and
    ``ffn_gate`` (and ``ffn_up``), so the backward reruns only the
    attention half's q, k and v projections (and under "ffn_lite" the up
    projection), as XLA's ``save_only_these_names`` does.  "ffn_offload"
    saves "ffn"'s tensors in one :class:`.training.HostStash` for the
    pass."""
    policy = cfg.remat_policy
    if policy not in training.SAVED_FFN:
        return training.remat(functools.partial(_layer, cfg, cos, sin),
                              policy)
    attn = training.remat(functools.partial(_attn_half, cfg, cos, sin),
                          "full")
    stash = training.HostStash() if policy == "ffn_offload" else None

    def block(x, lp):
        return training.swiglu_residual(
            attn(x, lp), lp["ln_mlp"], lp["w_gate"], lp["w_up"],
            lp["w_down"], cfg.rms_eps, policy, stash)

    return block


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: LlamaConfig) -> torch.Tensor:
    """Final-norm hidden states [B, S, hidden]: everything before the
    vocab projection.  With ``cfg.remat`` and grad enabled, each layer runs
    under the configured remat policy."""
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(cfg.dtype)
    cos, sin = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           scaling=cfg.rope_scaling_dict, device=x.device)
    if cfg.remat and torch.is_grad_enabled():
        block = _remat_block(cfg, cos, sin)
    else:
        block = functools.partial(_layer, cfg, cos, sin)
    for lp in unbind_layers(params):
        x = block(x, lp)
    return rms_norm(x, params["ln_final"], cfg.rms_eps)


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Logits [B, S, vocab] f32 (a matmul in cfg.dtype, then widened)."""
    x = forward_hidden(params, tokens, cfg)
    return (x @ params["lm_head"]).float()


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy over [B, S]; tokens [B, S+1]."""
    if cfg.xent_chunk > 0:
        x = forward_hidden(params, tokens[:, :-1], cfg)
        return training.chunked_next_token_xent(
            x, params["lm_head"], tokens, cfg.xent_chunk)
    logits = forward(params, tokens[:, :-1], cfg)
    return training.next_token_xent(logits, tokens)


def make_train_step(cfg: LlamaConfig, optimizer=None, device=None):
    """(step, init_all, optimizer) on one device (``device`` None means
    CUDA, and raises without it): ``step(params, opt_state, tokens) ->
    (params, opt_state, loss)`` with the parameters and moments updated in
    place; ``init_all(generator) -> (params, opt_state)``, the generator
    living on the device.  ``optimizer``: an optimizer object,
    ``"adam8bit"`` (``optim8bit.adamw8bit()``) or None
    (``training.adamw(3e-4, weight_decay=0.1)``)."""
    dev = resolve_device(device)
    return training.make_train_step(
        lambda params, tokens: loss_fn(params, tokens, cfg),
        lambda generator: init_params(cfg, generator, dev),
        optimizer,
    )
