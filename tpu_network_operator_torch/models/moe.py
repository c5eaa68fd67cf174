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
their plain versions on the CPU).

On a mesh (:class:`Layout`) the attention half is the dense model's
sharded layer, and the experts are sharded over ``expert`` with fsdp and
tensor within each expert, as the reference's :func:`param_specs` say.
Every expert rank of one data x fsdp coordinate holds the same rows, as
the reference's dispatch constraint ``P("expert", ("data", "fsdp"))``
leaves them: each routes its rows in full, runs only its own experts on
its slice of ``dispatch`` / ``combine``, and the partial outputs are
summed over expert x tensor.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import resolve_device, tracing
from ..ops.norms import rms_norm
from ..ops.rope import rope_angles
from ..parallel import comm
from . import llama, training
from .llama import (  # noqa: F401  (params_from_jax: the weight bridge)
    Params,
    init_weight,
    params_from_jax,
    shard_leaf,
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


def param_specs(cfg: MoEConfig) -> Params:
    """Per leaf, the mesh axis each dim is sharded over (None: whole), the
    reference's ``param_specs``: the experts dim on ``expert``, fsdp and
    tensor within each expert as the dense FFN has them, the router
    replicated, attention, embed and lm_head as the dense specs."""
    specs = llama.param_specs(cfg)
    layers = specs["layers"]
    return {**specs, "layers": {
        **layers,
        "router": (None, None, None),
        "w_gate": (None, "expert", "fsdp", "tensor"),
        "w_up": (None, "expert", "fsdp", "tensor"),
        "w_down": (None, "expert", "tensor", "fsdp"),
    }}


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_range(cfg: MoEConfig, mesh) -> Tuple[int, int]:
    """The experts [first, last) of this rank's ``expert`` coordinate (all
    of them without a mesh).  Raises a named ValueError where the experts
    do not divide over the axis."""
    if mesh is None:
        return 0, cfg.experts
    n = mesh.size("expert")
    if cfg.experts % n:
        raise ValueError(
            f"expert parallelism over {n} ranks needs the experts "
            f"({cfg.experts}) divisible by {n}"
        )
    per = cfg.experts // n
    return mesh.coord["expert"] * per, (mesh.coord["expert"] + 1) * per


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None, mesh=None) -> Params:
    """Stacked-layer parameters, expert weights ``[L, E, ...]``, drawn as
    :func:`.llama.init_params` draws them from ``generator`` (which must
    live on ``device``); the router in f32, the rest in ``cfg.dtype``.
    ``device`` None means CUDA, and raises without it.

    An expert leaf is drawn one expert's ``[L, in, out]`` slab at a time,
    in expert order, each cast into its place.  With ``mesh`` (anything
    with ``size`` and ``coord``: a :class:`..parallel.mesh.Mesh`, or a
    :class:`..parallel.mesh.MeshCoord` standing for a rank) the result is
    this rank's shards of :func:`param_specs`: every leaf and every slab
    is drawn in the same order, and only this rank's slice of each is
    kept, so a seed gives the same tree at every world size, and the
    transient peak is one f32 slab or one whole non-expert leaf."""
    dev = resolve_device(device)
    h, hd, f, n = cfg.hidden, cfg.head_dim, cfg.ffn, cfg.layers
    specs = param_specs(cfg)
    first, last = expert_range(cfg, mesh)

    def keep(leaf, spec):
        return leaf if mesh is None else shard_leaf(leaf, spec, mesh)

    def init(spec, shape, fan_in, dtype=cfg.dtype):
        return keep(init_weight(shape, fan_in, dtype, generator, dev), spec)

    def experts(name, fan_in):
        a, b = (f, h) if name == "w_down" else (h, f)
        spec = (None,) + specs["layers"][name][2:]
        out = None
        for e in range(cfg.experts):
            w = init_weight((n, a, b), fan_in, torch.float32, generator, dev)
            if first <= e < last:
                w = keep(w, spec)
                if out is None:
                    out = torch.empty((w.shape[0], last - first,
                                       *w.shape[1:]),
                                      dtype=cfg.dtype, device=dev)
                out[:, e - first].copy_(w)  # the cast of .to(cfg.dtype)
            # freed before the next slab is allocated: one f32 slab at a time
            del w
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layer = specs["layers"]
    return {
        "embed": init(specs["embed"], (cfg.vocab_size, h), h),
        "layers": {
            "wq": init(layer["wq"], (n, h, cfg.heads * hd), h),
            "wk": init(layer["wk"], (n, h, cfg.kv_heads * hd), h),
            "wv": init(layer["wv"], (n, h, cfg.kv_heads * hd), h),
            "wo": init(layer["wo"], (n, cfg.heads * hd, h), cfg.heads * hd),
            # router in f32: tiny, precision-sensitive
            "router": init(layer["router"], (n, h, cfg.experts), h,
                           torch.float32),
            "w_gate": experts("w_gate", h),
            "w_up": experts("w_up", h),
            "w_down": experts("w_down", f),
            "ln_attn": ones((n, h)),
            "ln_mlp": ones((n, h)),
        },
        "ln_final": ones((h,)),
        "lm_head": init(specs["lm_head"], (h, cfg.vocab_size), h),
    }


def shard_params(params: Params, cfg: MoEConfig, mesh) -> Params:
    """This rank's shard of every leaf of a whole MoE tree by
    :func:`param_specs`."""
    return llama.shard_tree(params, param_specs(cfg), mesh)


def gather_params(params: Params, cfg: MoEConfig, mesh) -> Params:
    """The whole MoE tree from every rank's shards, on every rank; for
    tests and checks."""
    return llama.gather_tree(params, param_specs(cfg), mesh)


class Layout(llama.Layout):
    """The dense :class:`.llama.Layout` (attention half, embed, lm_head,
    the batch over data x fsdp and the loss) plus the experts: this rank's
    range of them (:func:`expert_range`), the expert x tensor group that
    sums the expert FFN's partial outputs, and the data x fsdp group that
    sums the load-balancing statistics.  ``expert`` is no batch axis: the
    ranks along it hold the same rows and the same replicated leaves, so
    no gradient is summed over it.  The MoE keeps the whole sequence
    outside attention (the config has no ``seq_parallel``): a routing
    group is a whole batch row, under ring and Ulysses as without them.
    A pipeline stage (the dense layout's ``pipeline_stage`` and
    ``seq_parallel``) keeps each seq rank's chunk through the layer
    instead, and routes each (row, chunk) as a group of its own, as the
    reference's pipeline does."""

    def __init__(self, cfg: MoEConfig, mesh=None, attn_fn=None, **kw):
        self.experts = expert_range(cfg, mesh)
        super().__init__(cfg, mesh, attn_fn, **kw)
        if mesh is None:
            self.et = self.batch = None
            self.batch_shards = 1
            return
        self.et = mesh.group("expert", "tensor")
        self.batch = mesh.group("data", "fsdp")
        self.batch_shards = mesh.size("data", "fsdp")

    def specs(self) -> Params:
        return param_specs(self.cfg)


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
    ``probs`` through the normalized top-k values; ``dispatch`` none.
    While a profiler records, the forward counts the assignments past
    capacity (``moe.assignments_dropped``) and the capacity slots left
    empty (``moe.slots_empty``) with :func:`..tracing.count`."""
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
    # counts [B, E]: each expert's assignments before capacity; an expert
    # keeps min(count, capacity) of them
    tracing.count("moe.assignments_dropped",
                  lambda: (counts - capacity).clamp_min(0).sum())
    tracing.count("moe.slots_empty",
                  lambda: counts.numel() * capacity
                  - counts.clamp_max(capacity).sum())
    return dispatch, combine


def _moe_ffn(cfg: MoEConfig, lp: Params, y: torch.Tensor,
             layout: Optional[Layout] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse expert FFN.  y: [B, S, h] -> ([B, S, h], aux loss scalar).
    The router product is f32 x f32 (TF32 would flip routing decisions, so
    nothing here or in its callers turns it on).

    On a mesh (``layout``) each rank routes its rows in full and runs its
    own experts: ``y`` and the ``probs`` that feed ``combine`` enter the
    expert x tensor region through :func:`..parallel.comm.copy_to`, whose
    backward sums the ranks' partial gradients, and the partial outputs
    leave it through :func:`..parallel.comm.reduce_from`.  The router and
    the aux loss see ``probs`` directly, whole on every rank.  The aux
    loss's two [E] means are over the global batch: the ranks' sums are
    added over data x fsdp (:func:`..parallel.comm.psum`) before their
    product."""
    lay = layout or Layout(cfg)
    b, s, _ = y.shape
    with tracing.span("moe.route"):
        probs = torch.softmax(y.float() @ lp["router"], dim=-1)  # [B,S,E]
        dispatch, combine = route(comm.copy_to(probs, lay.et),
                                  cfg.experts_per_token, cfg.capacity(s))

        # Switch aux loss: experts balanced when the dispatched fraction
        # (after capacity drops) tracks 1/E
        sums = torch.stack([dispatch.any(-1).float().sum((0, 1)),
                            probs.sum((0, 1))])                   # [2,E]
        frac, mean_probs = comm.psum(sums, lay.batch) / (
            b * lay.batch_shards * s)
        aux = cfg.experts * (frac * mean_probs).sum()

    first, last = lay.experts
    if last - first < cfg.experts:
        dispatch = dispatch[:, :, first:last]
        combine = combine[:, :, first:last]
    with tracing.span("moe.dispatch"):
        y = comm.copy_to(y, lay.et)
        xin = torch.einsum("bsec,bsh->ebch", dispatch.to(cfg.dtype), y)
    with tracing.span("moe.experts"):
        gated = torch.nn.functional.silu(
            torch.einsum("ebch,ehf->ebcf", xin, lay.w(lp["w_gate"], 1))
        ) * torch.einsum("ebch,ehf->ebcf", xin, lay.w(lp["w_up"], 1))
        out = torch.einsum("ebcf,efh->ebch", gated, lay.w(lp["w_down"], 2))
    # combine: the weighted un-dispatch back to [B, S, h]
    with tracing.span("moe.combine"):
        y_out = comm.reduce_from(
            torch.einsum("ebch,bsec->bsh", out, combine.to(cfg.dtype)),
            lay.et)
    return y_out, aux


def ffn_over_expert_shards(cfg: MoEConfig, lp: Params, y: torch.Tensor,
                           shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert FFN of one layer (``lp``: that layer's leaves) split
    over ``shards`` expert ranks held in one process: each shard runs the
    mesh's per-rank body (:func:`_moe_ffn` over a
    :class:`..parallel.mesh.MeshCoord` of ``expert`` = ``shards``) on its
    slice of the expert leaves and of ``dispatch`` / ``combine``, and the
    partial outputs are summed in shard order, where a mesh sums them with
    ``reduce_from``.  Autograd sums ``y``'s and ``probs``' partial
    gradients over the shards, as ``copy_to``'s backward does on a mesh.
    The aux loss is the first shard's (every shard computes it alike).
    For checks that drive the mesh's seam on one device."""
    from ..parallel.mesh import MeshCoord, plan_axes

    plan = plan_axes(shards, expert=shards)
    specs = param_specs(cfg)["layers"]
    out = aux = None
    for i in range(shards):
        coord = MeshCoord(plan, {"expert": i})
        mine = {**lp, **{name: shard_leaf(lp[name], specs[name][1:], coord)
                         for name in EXPERT_LEAVES}}
        part, a = _moe_ffn(cfg, mine, y, Layout(cfg, coord))
        out = part if out is None else out + part
        aux = a if aux is None else aux
    return out, aux


def _layer(lay: Layout, cos, sin, x,
           lp) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE transformer block.  x: [B, S, H] -> (x', aux)."""
    x = llama._attn_half(lay, cos, sin, x, lp)
    y = rms_norm(x, lp["ln_mlp"], lay.cfg.rms_eps)
    ff, aux = _moe_ffn(lay.cfg, lp, y, lay)
    return x + ff, aux


# -- forward / loss / training ------------------------------------------------


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                   layout: Optional[Layout] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-norm hidden states [B, S, hidden], mean router aux loss over
    the layers): everything before the vocab projection.  With
    ``cfg.remat`` and grad enabled, each layer runs under
    ``cfg.remat_policy``.  ``layout``: this rank's part of a sharded model
    (None: the whole model on one device)."""
    lay = layout or Layout(cfg)
    x = torch.nn.functional.embedding(tokens, lay.whole(params["embed"]))
    x = x.to(cfg.dtype)
    cos, sin = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           device=x.device)
    block = functools.partial(_layer, lay, cos, sin)
    if cfg.remat and torch.is_grad_enabled():
        block = training.remat(block, cfg.remat_policy)
    auxes = []
    for lp in unbind_layers(params):
        x, aux = block(x, lp)
        auxes.append(aux)
    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    return x, torch.stack(auxes).mean()


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            layout: Optional[Layout] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, S, vocab] f32, mean router aux loss): the vocab
    projection in cfg.dtype, then widened."""
    lay = layout or Layout(cfg)
    x, aux = forward_hidden(params, tokens, cfg, lay)
    return (x @ lay.whole(params["lm_head"])).float(), aux


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            layout: Optional[Layout] = None) -> torch.Tensor:
    """Next-token cross entropy over [B, S] (tokens [B, S+1]) plus
    ``cfg.router_aux_weight`` times the router's load-balancing loss.  On
    a mesh, ``tokens`` are this rank's rows and the result its share of
    the global loss (:meth:`Layout.reduce_loss` sums the shares)."""
    lay = layout or Layout(cfg)
    if cfg.xent_chunk > 0:
        x, aux = forward_hidden(params, tokens[:, :-1], cfg, lay)
        ce = training.chunked_next_token_xent(
            x, lay.whole(params["lm_head"]), tokens, cfg.xent_chunk)
    else:
        logits, aux = forward(params, tokens[:, :-1], cfg, lay)
        ce = training.next_token_xent(logits, tokens)
    loss = ce + cfg.router_aux_weight * aux
    return loss if lay.loss_scale == 1.0 else loss * lay.loss_scale


def make_train_step(cfg: MoEConfig, optimizer=None, device=None, mesh=None,
                    attn_fn=None):
    """(step, init_all, optimizer) with :func:`.llama.make_train_step`'s
    contract (``device`` None means CUDA, and raises without it;
    ``optimizer`` an optimizer object, ``"adam8bit"`` or None for
    ``training.adamw(3e-4, weight_decay=0.1)``).  The attention is the
    dense model's route: flash where
    :func:`..ops.flash_attention.use_flash` passes, plain otherwise.

    ``mesh`` shards the step as :class:`Layout` says, the experts over
    ``expert``: ``init_all`` draws this rank's shards alone
    (:func:`init_params`), the same tree at every world size; ``step``
    takes this rank's rows (its coordinate along data x fsdp) and returns
    the global loss.  ``attn_fn``: ring or Ulysses attention over the seq
    axis."""
    dev = resolve_device(device)
    if mesh is None:
        return training.make_train_step(
            lambda params, tokens: loss_fn(params, tokens, cfg),
            lambda generator: init_params(cfg, generator, dev),
            optimizer,
        )
    llama.check_mesh_step(dev, mesh, optimizer)
    lay = Layout(cfg, mesh, attn_fn)
    return training.make_train_step(
        lambda params, tokens: loss_fn(params, tokens, cfg, lay),
        lambda generator: init_params(cfg, generator, mesh.device, mesh),
        optimizer, reduce_grads=lay.reduce_grads,
        reduce_loss=lay.reduce_loss, mesh=mesh, param_specs=lay.specs(),
    )
