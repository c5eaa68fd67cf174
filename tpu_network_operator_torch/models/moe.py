"""Mixtral-family sparse Mixture-of-Experts transformer in PyTorch.

Counterpart of ``tpu_network_operator/models/moe.py`` on one device: the
reference's GShard-style dense dispatch, top-k capacity routing
materialized as ``dispatch`` / ``combine`` one-hot tensors and applied with
einsums, with tokens past an expert's capacity dropped (they pass through
the residual stream), the router in f32, the experts in ``cfg.dtype`` and
the Switch load-balancing auxiliary loss.  The parameter layout is the
reference's: stacked ``[L, ...]`` layer leaves, expert leaves ``[L, E,
...]`` and ``x @ W`` with ``W[in, out]``, so :func:`params_from_jax`
carries a JAX MoE tree across by name, the f32 router included.  The
attention, the norms and RoPE are the dense model's (kernels on CUDA,
their plain versions on the CPU).  Expert parallelism waits for the mesh.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import resolve_device
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_angles
from . import training
from .llama import (  # noqa: F401  (params_from_jax: the weight bridge)
    Params,
    attention,
    init_weight,
    params_from_jax,
    unbind_layers,
)


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    ffn: int = 14_336            # per-expert FFN width
    experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    max_seq: int = 32_768
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # training.remat's policy names; the MoE layer tags no tensor, so
    # "ffn", "ffn_lite" and "ffn_offload" save what "full" saves, as in
    # the reference
    remat_policy: str = "dots"
    # >0: training cross entropy in sequence chunks of this size
    # (training.chunked_next_token_xent); 0 = full logits
    xent_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def capacity(self, tokens_per_group: int) -> int:
        """Static per-expert capacity for a routing group of that size."""
        cap = math.ceil(
            self.experts_per_token * tokens_per_group / self.experts
            * self.capacity_factor
        )
        return max(cap, 1)

    def num_params(self) -> int:
        """Exact parameter count (all experts; router included)."""
        per_layer = (
            self.hidden * (self.heads + 2 * self.kv_heads) * self.head_dim
            + self.heads * self.head_dim * self.hidden
            + self.experts * 3 * self.hidden * self.ffn
            + self.hidden * self.experts
            + 2 * self.hidden
        )
        return (
            2 * self.vocab_size * self.hidden
            + self.layers * per_layer
            + self.hidden
        )

    # -- presets ------------------------------------------------------------

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig()

    @staticmethod
    def small() -> "MoEConfig":
        """~1B-active bench preset."""
        return MoEConfig(
            hidden=2048, layers=16, heads=16, kv_heads=8, ffn=5632,
            experts=8,
        )

    @staticmethod
    def tiny(vocab: int = 256) -> "MoEConfig":
        """Test config: small but structurally identical."""
        return MoEConfig(
            vocab_size=vocab, hidden=64, layers=2, heads=4, kv_heads=2,
            ffn=128, experts=4, experts_per_token=2, max_seq=128,
            remat=False,
        )


# -- parameters ---------------------------------------------------------------


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> Params:
    """Stacked-layer parameters, expert weights ``[L, E, ...]``, drawn as
    :func:`.llama.init_params` draws them from ``generator`` (which must
    live on ``device``); the router in f32, the rest in ``cfg.dtype``.
    ``device`` None means CUDA, and raises without it."""
    dev = resolve_device(device)
    h, hd, f, n, e = cfg.hidden, cfg.head_dim, cfg.ffn, cfg.layers, \
        cfg.experts

    def init(shape, fan_in, dtype=cfg.dtype):
        return init_weight(shape, fan_in, dtype, generator, dev)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": init((cfg.vocab_size, h), h),
        "layers": {
            "wq": init((n, h, cfg.heads * hd), h),
            "wk": init((n, h, cfg.kv_heads * hd), h),
            "wv": init((n, h, cfg.kv_heads * hd), h),
            "wo": init((n, cfg.heads * hd, h), cfg.heads * hd),
            # router in f32: tiny, precision-sensitive
            "router": init((n, h, e), h, torch.float32),
            "w_gate": init((n, e, h, f), h),
            "w_up": init((n, e, h, f), h),
            "w_down": init((n, e, f, h), f),
            "ln_attn": ones((n, h)),
            "ln_mlp": ones((n, h)),
        },
        "ln_final": ones((h,)),
        "lm_head": init((h, cfg.vocab_size), h),
    }


# -- routing + expert layer ---------------------------------------------------


def top_k_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k most probable experts [B, S, k], in order, ties to
    the lower expert index as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` leaves the order of ties
    unspecified)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def route(probs: torch.Tensor, k: int,
          capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity routing of ``probs`` [B, S, E] (the f32 router
    softmax) -> (dispatch [B, S, E, C] bool, combine [B, S, E, C] f32).

    Each batch row is a routing group: its tokens compete for the same
    per-expert capacity slots, earlier sequence positions and earlier
    top-k slots first (the GShard priority order); the experts are
    :func:`top_k_experts`.  The capacity positions are integer cumulative
    sums, exact on every device.  ``combine`` carries the gradient to
    ``probs`` through the normalized top-k values; ``dispatch`` none."""
    e = probs.shape[-1]
    gate_idx = top_k_experts(probs.detach(), k)                  # [B,S,k]
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    experts = torch.arange(e, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = combine = None
    counts = torch.zeros(probs.shape[0], e, dtype=torch.int64,
                         device=probs.device)                    # [B,E]
    for slot in range(k):
        m = (gate_idx[..., slot, None] == experts).long()        # [B,S,E]
        # position of each token within its expert's capacity buffer
        pos_e = torch.cumsum(m, dim=1) - m + counts[:, None, :]
        pos = (pos_e * m).sum(-1)                                # [B,S]
        keep = (pos < capacity)[..., None] & m.bool()            # [B,S,E]
        # a dropped token (pos >= capacity) matches no slot: an all-zero
        # row, as jax.nn.one_hot gives out of range
        pos_oh = pos[..., None] == slots                         # [B,S,C]
        d = keep[..., None] & pos_oh[:, :, None, :]              # [B,S,E,C]
        w = gate_vals[..., slot, None, None] * d
        dispatch = d if dispatch is None else dispatch | d
        combine = w if combine is None else combine + w
        counts = counts + m.sum(1)
    return dispatch, combine


def _moe_ffn(cfg: MoEConfig, lp: Params,
             y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse expert FFN.  y: [B, S, h] -> ([B, S, h], aux loss scalar).
    The router product is f32 x f32 (TF32 would flip routing decisions, so
    nothing here or in its callers turns it on)."""
    probs = torch.softmax(y.float() @ lp["router"], dim=-1)      # [B,S,E]
    dispatch, combine = route(probs, cfg.experts_per_token,
                              cfg.capacity(y.shape[1]))

    # Switch aux loss: experts balanced when the dispatched fraction (after
    # capacity drops) tracks 1/E
    frac = dispatch.any(-1).float().mean((0, 1))                 # [E]
    aux = cfg.experts * (frac * probs.mean((0, 1))).sum()

    xin = torch.einsum("bsec,bsh->ebch", dispatch.to(cfg.dtype), y)
    gated = torch.nn.functional.silu(
        torch.einsum("ebch,ehf->ebcf", xin, lp["w_gate"])
    ) * torch.einsum("ebch,ehf->ebcf", xin, lp["w_up"])
    out = torch.einsum("ebcf,efh->ebch", gated, lp["w_down"])
    # combine: the weighted un-dispatch back to [B, S, h]
    y_out = torch.einsum("ebch,bsec->bsh", out, combine.to(cfg.dtype))
    return y_out, aux


def _layer(cfg: MoEConfig, cos, sin, x,
           lp) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE transformer block.  x: [B, S, H] -> (x', aux)."""
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
    ff, aux = _moe_ffn(cfg, lp, y)
    return x + ff, aux


# -- forward / loss / training ------------------------------------------------


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-norm hidden states [B, S, hidden], mean router aux loss over
    the layers): everything before the vocab projection.  With
    ``cfg.remat`` and grad enabled, each layer runs under
    ``cfg.remat_policy``."""
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(cfg.dtype)
    cos, sin = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           device=x.device)
    block = functools.partial(_layer, cfg, cos, sin)
    if cfg.remat and torch.is_grad_enabled():
        block = training.remat(block, cfg.remat_policy)
    auxes = []
    for lp in unbind_layers(params):
        x, aux = block(x, lp)
        auxes.append(aux)
    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    return x, torch.stack(auxes).mean()


def forward(params: Params, tokens: torch.Tensor,
            cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, S, vocab] f32, mean router aux loss): the vocab
    projection in cfg.dtype, then widened."""
    x, aux = forward_hidden(params, tokens, cfg)
    return (x @ params["lm_head"]).float(), aux


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy over [B, S] (tokens [B, S+1]) plus
    ``cfg.router_aux_weight`` times the router's load-balancing loss."""
    if cfg.xent_chunk > 0:
        x, aux = forward_hidden(params, tokens[:, :-1], cfg)
        ce = training.chunked_next_token_xent(
            x, params["lm_head"], tokens, cfg.xent_chunk)
        return ce + cfg.router_aux_weight * aux
    logits, aux = forward(params, tokens[:, :-1], cfg)
    return training.next_token_xent(logits, tokens) \
        + cfg.router_aux_weight * aux


def make_train_step(cfg: MoEConfig, optimizer=None, device=None):
    """(step, init_all, optimizer) on one device, with
    :func:`.llama.make_train_step`'s contract (``device`` None means CUDA,
    and raises without it; ``optimizer`` an optimizer object,
    ``"adam8bit"`` or None for ``training.adamw(3e-4, weight_decay=0.1)``).
    The attention is the dense model's route: flash where
    :func:`..ops.flash_attention.use_flash` passes, plain otherwise."""
    dev = resolve_device(device)
    return training.make_train_step(
        lambda params, tokens: loss_fn(params, tokens, cfg),
        lambda generator: init_params(cfg, generator, dev),
        optimizer,
    )
