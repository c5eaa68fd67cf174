"""Llama-3-family transformer in PyTorch.

Counterpart of ``tpu_network_operator/models/llama.py`` on one device:
the forward, the training loss (full or chunked cross entropy) with the
layers under the configured remat policy, and the train step.  The
parameter layout is the reference's, so weights move between the two
packages by name: a plain dict whose layer leaves are stacked ``[L, ...]``
and whose projections are ``W[in, out]`` applied as ``x @ W``.  The layers
run in a Python loop over the stacked leaves, unbound once per forward.
That skeleton (embed, layers, final norm, logits, loss, train step) is
written once, on :class:`Layout`, for both families: the MoE
(``models/moe.py``) supplies only its block, its mesh draw and its specs.

Both families (this one and ``models/moe.py``) also run the geometry of
hybrid-attention models (:class:`HybridLlamaConfig`, ``HybridMoEConfig``):
an explicit head dim, a per-layer attention type (``layer_types``: full
causal attention, or a sliding window of ``sliding_window`` keys) and a
RoPE for each type (``rope_parameters``, as the published configs name
them).  The plain configs keep the reference's fields: every layer full
attention under the one RoPE of ``rope_theta`` and ``rope_scaling``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, tracing
from ..ops import flash_attention as fa
from ..ops.attention import causal_attention, repeat_kv
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_angles
from ..parallel import comm
from ..parallel.ring import _gqa_repeat_factor, make_ring_attn_fn
from . import training

Params = Dict[str, Any]

FULL, SLIDING = "full_attention", "sliding_attention"


def freeze_rope_parameters(params) -> Tuple:
    """A ``rope_parameters`` mapping ({layer type: {key: value}}) in the
    hashable stored form: sorted (type, sorted items) pairs."""
    if not params:
        return ()
    if not isinstance(params, Mapping):
        params = {t: dict(items) for t, items in params}
    return tuple(sorted((t, tuple(sorted(dict(spec).items())))
                        for t, spec in params.items()))


@dataclass(frozen=True)
class Hybrid:
    """The fields a hybrid-attention config adds to its family's
    (``HybridLlamaConfig``, ``moe.HybridMoEConfig``)."""

    # the head dim where the published config gives one that differs from
    # hidden / heads; 0 = hidden // heads.  Read via head_dim
    explicit_head_dim: int = 0
    # per layer, FULL or SLIDING (empty: every layer FULL); SLIDING layers
    # see the last sliding_window keys of each query
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0
    # per layer type, its RoPE ({type: {rope_type, rope_theta, ...}}, the
    # published rope_parameters) in freeze_rope_parameters' form; a type
    # not named takes rope_theta (and a dense config's rope_scaling)
    rope_parameters: Tuple = ()

    def __post_init__(self):
        check_geometry(self)

    @property
    def head_dim(self) -> int:
        return self.explicit_head_dim or self.hidden // self.heads


def check_geometry(cfg) -> None:
    """The hybrid-attention fields of a config, normalised in place
    (lists read from JSON become tuples) and validated."""
    object.__setattr__(cfg, "layer_types", tuple(cfg.layer_types))
    object.__setattr__(cfg, "rope_parameters",
                       freeze_rope_parameters(cfg.rope_parameters))
    if cfg.layer_types and len(cfg.layer_types) != cfg.layers:
        raise ValueError(f"layer_types names {len(cfg.layer_types)} layers, "
                         f"the config has {cfg.layers}")
    unknown = set(cfg.layer_types) - {FULL, SLIDING}
    if unknown:
        raise ValueError(f"unknown layer types {sorted(unknown)}; the port "
                         f"runs {FULL!r} and {SLIDING!r}")
    if SLIDING in cfg.layer_types and cfg.sliding_window <= 0:
        raise ValueError(f"{SLIDING!r} layers need sliding_window > 0")


def layer_windows(cfg) -> List[int]:
    """Each layer's attention window: 0 for full causal attention, else
    ``cfg.sliding_window`` keys (a plain config: every layer 0)."""
    types = getattr(cfg, "layer_types", ()) or (FULL,) * cfg.layers
    return [cfg.sliding_window if t == SLIDING else 0 for t in types]


def rope_tables(cfg, seq_len: int, device) -> Dict[int, Tuple[torch.Tensor,
                                                            torch.Tensor]]:
    """(cos, sin) of every window the layers use (0: full attention),
    each from its layer type's ``rope_parameters`` entry, else from
    ``rope_theta`` and the config's ``rope_scaling`` (if it has one)."""
    specs = {t: dict(items) for t, items in getattr(cfg, "rope_parameters",
                                                    ())}
    scaling = getattr(cfg, "rope_scaling_dict", None)
    out = {}
    for w in sorted(set(layer_windows(cfg))):
        spec = dict(specs.get(SLIDING if w else FULL, {}))
        theta = spec.pop("rope_theta", cfg.rope_theta)
        out[w] = rope_angles(seq_len, cfg.head_dim, theta,
                             scaling=spec or scaling, device=device,
                             max_positions=cfg.max_seq)
    return out


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
    # on a mesh with a seq axis: keep the activations sequence-sharded
    # through the layer (each rank its chunk of the sequence, ring
    # attention between), where False computes everything but attention
    # replicated over the seq ranks
    seq_parallel: bool = False
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


@dataclass(frozen=True)
class HybridLlamaConfig(Hybrid, LlamaConfig):
    """A dense config with the hybrid-attention fields (:class:`Hybrid`)."""


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
    """A copy of ``params`` on ``device`` (same tree, same dtypes), cut
    from autograd: a copy of a leaf that requires grad would otherwise
    keep that leaf alive through its graph."""
    dev = torch.device(device)
    return {
        k: params_to(v, dev) if isinstance(v, Mapping)
        else v.detach().to(dev)
        for k, v in params.items()
    }


# -- sharding -----------------------------------------------------------------


def param_specs(cfg: LlamaConfig) -> Params:
    """Per leaf, the mesh axis each dim is sharded over (None: whole), the
    reference's ``param_specs``: tensor parallelism on the head / ffn
    dims, fsdp on the complementary dim, the stacked-layer dim whole."""
    return {
        "embed": ("fsdp", "tensor"),
        "layers": {
            "wq": (None, "fsdp", "tensor"),
            "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"),
            "wo": (None, "tensor", "fsdp"),
            "w_gate": (None, "fsdp", "tensor"),
            "w_up": (None, "fsdp", "tensor"),
            "w_down": (None, "tensor", "fsdp"),
            "ln_attn": (None, None),
            "ln_mlp": (None, None),
        },
        "ln_final": (None,),
        "lm_head": ("fsdp", "tensor"),
    }


def shard_leaf(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of one whole leaf (a contiguous copy where it is
    cut): dim i cut into ``mesh.size(axis)`` chunks where ``spec`` names
    an axis, this rank's chunk kept.  ``mesh`` needs only ``size`` and
    ``coord`` (a :class:`..parallel.mesh.MeshCoord` will do).  Raises
    where a dim does not divide."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = mesh.size(axis)
        if leaf.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of a {tuple(leaf.shape)} leaf does not "
                f"shard over the {n} ranks of axis {axis!r}"
            )
        leaf = leaf.chunk(n, dim=dim)[mesh.coord[axis]]
    return leaf.contiguous()


def shard_tree(params: Params, specs: Params, mesh) -> Params:
    """:func:`shard_leaf` over a tree, each leaf paired with its spec by
    name."""
    return training.map_by_name(params, specs,
                      lambda leaf, spec: shard_leaf(leaf, spec, mesh))


def gather_tree(params: Params, specs: Params, mesh) -> Params:
    """The whole tree from every rank's shards (:func:`shard_tree`'s
    inverse), on every rank; for tests and checks."""
    def gather(leaf, spec):
        leaf = leaf.detach()
        for dim, axis in enumerate(spec):
            if axis is not None:
                leaf = comm.all_gather(leaf, mesh.group(axis), dim)
        return leaf

    return training.map_by_name(params, specs, gather)


def shard_params(params: Params, cfg: LlamaConfig, mesh) -> Params:
    """This rank's shard of every leaf of a whole tree by
    :func:`param_specs` (each a contiguous copy, so the whole tree can be
    freed)."""
    return shard_tree(params, param_specs(cfg), mesh)


def gather_params(params: Params, cfg: LlamaConfig, mesh) -> Params:
    """The whole tree from every rank's shards (:func:`shard_params`'s
    inverse), on every rank; for tests and checks."""
    return gather_tree(params, param_specs(cfg), mesh)


class Layout:
    """Where this process's part of the model lives, and the collectives
    that join it to the rest: the whole model on one device (``mesh``
    None: every collective the identity, the single-device path), or this
    rank's shards of :func:`param_specs` on a mesh of data x fsdp x seq x
    tensor ranks.

    On a mesh, each layer leaf's fsdp dim is gathered per layer in the
    forward and reduce-scattered in the backward (:func:`.comm.gather_sum`);
    ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up`` are column-parallel on
    ``tensor`` (their input entered with :func:`.comm.copy_to`), ``wo`` and
    ``w_down`` row-parallel (their partial sums all-reduced with
    :func:`.comm.reduce_from`); ``embed`` and ``lm_head`` are gathered
    whole before use.  The batch is sharded over data x fsdp.  With a seq
    axis and ``attn_fn`` (ring or Ulysses), each rank either computes all
    but attention over the whole sequence, replicated over the seq ranks,
    splitting q/k/v before ``attn_fn`` and gathering its output after
    (``cfg.seq_parallel`` False), or keeps its chunk of the sequence
    through the layer (True); without ``attn_fn`` attention runs on the
    whole local sequence, as the reference's mesh attention does outside
    the ring.  ``seq_parallel`` (None: ``cfg.seq_parallel``) picks
    between the two.  The dense model names no ``expert`` axis, so its
    ranks replicate; ``pipe`` replicates when ``serving`` (the reference's
    generate shards by the same specs).  Training over ``pipe`` runs
    through :mod:`..parallel.pipeline`, whose stages each hold a layout
    with ``pipeline_stage`` (the sub-mesh of one pipe coordinate: every
    group here joins ranks that share it); the plain train step refuses a
    pipe axis.  The MoE's layout (``models/moe.py``) adds the experts.

    A layout is also its model family: the decoder's skeleton is written
    once here (:meth:`hidden`, :meth:`logits`, :meth:`loss`), over what a
    family supplies: :meth:`block`, :meth:`draw`, :meth:`specs` and
    ``aux_weight``, the weight of the blocks' aux loss (the dense block
    gives none).

    Sliding-window layers run their attention on the whole local sequence
    (:func:`attention`): a windowed config refuses ring and Ulysses
    attention and pipeline stages (:func:`check_no_window`)."""

    aux_weight = 0.0

    def __init__(self, cfg, mesh=None, attn_fn=None, serving: bool = False,
                 pipeline_stage: bool = False,
                 seq_parallel: Optional[bool] = None):
        self.cfg, self.mesh = cfg, mesh
        self.attn = attn_fn or functools.partial(attention, cfg)
        if attn_fn is not None:
            check_no_window(cfg, "ring or Ulysses attention")
        if pipeline_stage:
            check_no_window(cfg, "a pipeline stage")
        if mesh is None:
            self.fsdp = self.tp = self.sp = None
            self.heads, self.kv_heads, self.kv_rep = cfg.heads, cfg.kv_heads, 1
            self.seq_shards, self.seq_index, self.seq_split = 1, 0, False
            self.batch_axes, self.loss_scale = (), 1.0
            return
        if mesh.size("pipe") > 1 and not (serving or pipeline_stage):
            raise ValueError(
                f"training over a 'pipe' axis runs through "
                f"parallel.pipeline.make_pipeline_train_step, not the plain "
                f"train step; got {mesh.shape}"
            )
        t, n = mesh.size("tensor"), mesh.size("seq")
        if cfg.heads % t or cfg.ffn % t:
            raise ValueError(
                f"tensor parallelism over {t} ranks needs heads "
                f"({cfg.heads}) and ffn ({cfg.ffn}) divisible by {t}"
            )
        self.fsdp = mesh.group("fsdp")
        self.tp = mesh.group("tensor")
        self.sp = mesh.group("seq")
        self.heads = cfg.heads // t
        # kv heads that do not divide the tensor shards are gathered,
        # repeated by the reference's ring factor and re-split
        self.kv_rep = 1 if cfg.kv_heads % t == 0 else _gqa_repeat_factor(
            cfg.heads, cfg.kv_heads, t)
        self.kv_heads = cfg.kv_heads * self.kv_rep // t
        if seq_parallel is None:
            seq_parallel = getattr(cfg, "seq_parallel", False)
        sp = seq_parallel and n > 1
        if sp and attn_fn is None:
            check_no_window(cfg, "ring attention")
            self.attn = make_ring_attn_fn(mesh)
        self.seq_split = n > 1 and attn_fn is not None and not sp
        self.seq_shards = n if sp else 1
        self.seq_index = mesh.coord["seq"] if sp else 0
        self.batch_axes = ("data", "fsdp") + (("seq",) if sp else ())
        self.loss_scale = 1.0 / (mesh.size("data", "fsdp") * self.seq_shards)

    # -- parameters

    def specs(self) -> Params:
        """The model's :func:`param_specs`: what each leaf is sharded
        over."""
        return param_specs(self.cfg)

    def draw(self, generator: torch.Generator, device=None) -> Params:
        """This process's part of a tree drawn from ``generator`` (which
        lives on the device): the whole tree on ``device``, or on a mesh
        the whole tree drawn on the mesh's device and this rank's shards
        of :meth:`specs` kept, so a seed gives the same parameters at
        every world size."""
        if self.mesh is None:
            return init_params(self.cfg, generator, device)
        return shard_tree(init_params(self.cfg, generator, self.mesh.device),
                          self.specs(), self.mesh)

    def block(self, cos, sin, window: int = 0):
        """One layer as ``fn(x, lp) -> (x, aux)``, under
        ``cfg.remat_policy`` (:func:`_remat_block`) where ``cfg.remat``
        and grad are on; the dense block gives no aux (None), and the
        pair is made outside the checkpoint."""
        if self.cfg.remat and torch.is_grad_enabled():
            layer = _remat_block(self, cos, sin, window)
        else:
            layer = functools.partial(_layer, self, cos, sin, window=window)
        return lambda x, lp: (layer(x, lp), None)

    def w(self, leaf: torch.Tensor, fsdp_dim: int) -> torch.Tensor:
        """A layer leaf with its fsdp dim gathered."""
        return comm.gather_sum(leaf, self.fsdp, fsdp_dim)

    def whole(self, leaf: torch.Tensor) -> torch.Tensor:
        """``embed`` or ``lm_head`` gathered whole (fsdp dim 0, tensor 1)."""
        return comm.gather(comm.gather_sum(leaf, self.fsdp, 0), self.tp, 1)

    def kv(self, cols: torch.Tensor, b: int, s: int) -> torch.Tensor:
        """K or V of this rank's heads from its column-parallel output."""
        hd = self.cfg.head_dim
        if self.kv_rep == 1:
            return cols.reshape(b, s, self.kv_heads, hd)
        full = comm.gather(cols, self.tp, 2).reshape(b, s, self.cfg.kv_heads,
                                                     hd)
        return comm.split(repeat_kv(full, self.kv_rep), self.tp, 2)

    # -- the batch and the loss

    def local_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's [B, s + 1] window of its rows [B, S + 1]: all of
        it, or under sequence parallelism its chunk and the next token."""
        if self.seq_shards == 1:
            return tokens
        c = (tokens.shape[1] - 1) // self.seq_shards
        return tokens[:, self.seq_index * c:(self.seq_index + 1) * c + 1]

    def hidden(self, params: Params, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(final-norm hidden states [B, S, hidden], the mean over the
        layers of the blocks' aux losses, or None where the blocks give
        none): everything before the vocab projection."""
        cfg = self.cfg
        x = torch.nn.functional.embedding(tokens, self.whole(params["embed"]))
        x = x.to(cfg.dtype)
        tables = rope_tables(cfg, tokens.shape[1] * self.seq_shards, x.device)
        blocks = {w: self.block(*t, w) for w, t in tables.items()}
        auxes = []
        for lp, w in zip(unbind_layers(params), layer_windows(cfg)):
            x, aux = blocks[w](x, lp)
            if aux is not None:
                auxes.append(aux)
        x = rms_norm(x, params["ln_final"], cfg.rms_eps)
        return x, torch.stack(auxes).mean() if auxes else None

    def logits(self, params: Params, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(logits [B, S, vocab] f32, :meth:`hidden`'s aux): the vocab
        projection in cfg.dtype, then widened."""
        x, aux = self.hidden(params, tokens)
        return (x @ self.whole(params["lm_head"])).float(), aux

    def xent(self, lm_head: torch.Tensor, x: torch.Tensor,
             tokens: torch.Tensor) -> torch.Tensor:
        """Next-token cross entropy of final-norm hidden states x [B, S,
        H] (tokens [B, S+1]): over the full logits, or in sequence chunks
        of ``cfg.xent_chunk``."""
        head = self.whole(lm_head)
        if self.cfg.xent_chunk > 0:
            return training.chunked_next_token_xent(x, head, tokens,
                                                    self.cfg.xent_chunk)
        return training.next_token_xent((x @ head).float(), tokens)

    def loss(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token cross entropy over [B, S] (tokens [B, S+1]), plus
        ``aux_weight`` times the blocks' aux loss where they give one.  On
        a mesh, ``tokens`` are this rank's rows and the result its share
        of the global loss (:meth:`reduce_loss` sums the shares)."""
        tokens = self.local_tokens(tokens)
        x, aux = self.hidden(params, tokens[:, :-1])
        loss = self.xent(params["lm_head"], x, tokens)
        if aux is not None:
            loss = loss + self.aux_weight * aux
        return loss if self.loss_scale == 1.0 else loss * self.loss_scale

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global token mean from every rank's share of it."""
        if self.mesh is None:
            return loss
        return comm.all_reduce(loss, self.mesh.group(*self.batch_axes))

    def reduce_grads(self, params: Params,
                     grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients (in ``params``' leaf order) summed over the
        batch-splitting axes each leaf is whole on (over fsdp the
        backward's reduce-scatter already summed the sharded leaves), one
        all-reduce per group and dtype."""
        if self.mesh is None:
            return grads
        specs = list(training.tree_leaves(
            training.map_by_name(params, self.specs(), lambda _, s: s)))
        buckets: Dict[tuple, List[int]] = {}
        for i, spec in enumerate(specs):
            axes = tuple(a for a in self.batch_axes if a not in spec)
            if self.mesh.size(*axes) > 1:
                buckets.setdefault((axes, grads[i].dtype), []).append(i)
        grads = list(grads)
        for (axes, _), idx in buckets.items():
            flat = comm.all_reduce(
                torch.cat([grads[i].reshape(-1) for i in idx]),
                self.mesh.group(*axes))
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                grads[i] = part.view(grads[i].shape)
        return grads


def check_no_window(cfg, what: str) -> None:
    """Raise where a config with sliding-window layers meets a path that
    takes no window."""
    if any(layer_windows(cfg)):
        raise ValueError(
            f"sliding-window attention (window {cfg.sliding_window}) is not "
            f"supported under {what}: the window runs on the whole local "
            "sequence only")


def unbind_layers(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Every layer's slice of the stacked leaves, from one ``unbind`` per
    leaf: its backward is one stack of the layer gradients, where indexing
    each layer would write a zero-filled full-size gradient per layer."""
    names = list(params["layers"])
    slices = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, per_layer)) for per_layer in zip(*slices)]


# -- forward ------------------------------------------------------------------


def attention(cfg: LlamaConfig, q, k, v, window: int = 0) -> torch.Tensor:
    """Flash (kernel on CUDA, its plain version on CPU) where
    :func:`..ops.flash_attention.use_flash` routes the shape to it, plain
    causal attention otherwise; ``window`` > 0 narrows either to the
    sliding window."""
    if fa.use_flash(q.shape[1], k.shape[1], cfg.head_dim):
        return fa.flash_attention(q, k, v, window=window)
    return causal_attention(q, k, v, window=window)


def _attn_half(lay: Layout, cos, sin, x, lp, window: int = 0) -> torch.Tensor:
    """The attention half of a block: the post-attention residual
    (the reference's ``resid_mid``).  x: [B, S, H].  ``window``: the
    layer's sliding window (0: full attention); the attention itself runs
    inside the span ``attn.window`` or ``attn.full``."""
    cfg = lay.cfg
    y = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    b, s, _ = y.shape
    y = comm.copy_to(y, lay.tp)
    q = (y @ lay.w(lp["wq"], 0)).reshape(b, s, lay.heads, cfg.head_dim)
    k = lay.kv(y @ lay.w(lp["wk"], 0), b, s)
    v = lay.kv(y @ lay.w(lp["wv"], 0), b, s)
    q = apply_rope(q, cos, sin, lay.seq_index * s)
    k = apply_rope(k, cos, sin, lay.seq_index * s)
    if lay.seq_split:
        q, k, v = (comm.split(t, lay.sp, 1) for t in (q, k, v))
    with tracing.span("attn.window" if window else "attn.full"):
        a = attention(cfg, q, k, v, window) if window else lay.attn(q, k, v)
    if lay.seq_split:
        a = comm.gather(a, lay.sp, 1)
    out = a.reshape(b, s, -1) @ lay.w(lp["wo"], 1)
    return x + comm.reduce_from(out, lay.tp)


def ffn_half(lay: Layout, x, lp) -> torch.Tensor:
    """The FFN half of a dense block: x + SwiGLU(rms_norm(x)), the down
    projection's partial sums all-reduced over tensor.  x: [B, S, H], the
    post-attention residual; the training layer and the serving block
    (``models/generate.py``) both end with it."""
    y = comm.copy_to(rms_norm(x, lp["ln_mlp"], lay.cfg.rms_eps), lay.tp)
    gate = y @ lay.w(lp["w_gate"], 0)
    up = y @ lay.w(lp["w_up"], 0)
    out = (torch.nn.functional.silu(gate) * up) @ lay.w(lp["w_down"], 1)
    return x + comm.reduce_from(out, lay.tp)


def _layer(lay: Layout, cos, sin, x, lp, window: int = 0) -> torch.Tensor:
    """One transformer block.  x: [B, S, H]; lp: this layer's params."""
    return ffn_half(lay, _attn_half(lay, cos, sin, x, lp, window), lp)


def _remat_block(lay: Layout, cos, sin, window: int = 0):
    """A block under ``cfg.remat_policy``.  "ffn" / "ffn_lite" keep the
    reference's named tensors: the attention half is recomputed from the
    block's input, and the FFN half saves its input (``resid_mid``) and
    ``ffn_gate`` (and ``ffn_up``), so the backward reruns only the
    attention half's q, k and v projections (and under "ffn_lite" the up
    projection), as XLA's ``save_only_these_names`` does.  "ffn_offload"
    saves "ffn"'s tensors in one :class:`.training.HostStash` for the
    pass."""
    cfg = lay.cfg
    policy = cfg.remat_policy
    if policy not in training.SAVED_FFN:
        return training.remat(
            functools.partial(_layer, lay, cos, sin, window=window), policy)
    attn = training.remat(
        functools.partial(_attn_half, lay, cos, sin, window=window), "full")
    stash = training.HostStash() if policy == "ffn_offload" else None

    def block(x, lp):
        return training.swiglu_residual(
            attn(x, lp), lp["ln_mlp"], lay.w(lp["w_gate"], 0),
            lay.w(lp["w_up"], 0), lay.w(lp["w_down"], 1), cfg.rms_eps,
            policy, stash, lay.tp)

    return block


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   layout: Optional[Layout] = None) -> torch.Tensor:
    """Final-norm hidden states [B, S, hidden] (:meth:`Layout.hidden`).
    ``layout``: this rank's part of a sharded model (None: the whole model
    on one device)."""
    return (layout or Layout(cfg)).hidden(params, tokens)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            layout: Optional[Layout] = None) -> torch.Tensor:
    """Logits [B, S, vocab] f32 (:meth:`Layout.logits`)."""
    return (layout or Layout(cfg)).logits(params, tokens)[0]


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            layout: Optional[Layout] = None) -> torch.Tensor:
    """Next-token cross entropy over [B, S]; tokens [B, S+1]
    (:meth:`Layout.loss`)."""
    return (layout or Layout(cfg)).loss(params, tokens)


def check_mesh_step(device: torch.device, mesh, optimizer) -> None:
    """The refusals of a train step on a mesh, dense or MoE: a device
    that is not the mesh's, and an 8-bit optimizer built for another mesh
    (``"adam8bit"`` builds it for this one), whose state would not be
    this rank's slice of the global state."""
    from .optim8bit import AdamW8bit

    if device.type != mesh.device.type:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    if isinstance(optimizer, AdamW8bit) and optimizer.mesh is not mesh \
            and mesh.plan.size() > 1:
        raise ValueError(
            "an adamw8bit optimizer on a mesh of more than one rank must be "
            "built with that mesh and the model's param_specs (or pass "
            "'adam8bit')"
        )


def make_train_step(cfg, optimizer=None, device=None, mesh=None,
                    attn_fn=None):
    """(step, init_all, optimizer) of either family, its :class:`Layout`
    picked by the config's type (:func:`.convert.model`): ``step(params,
    opt_state, tokens) -> (params, opt_state, loss)`` with the parameters
    and moments updated in place; ``init_all(generator) -> (params,
    opt_state)``, the generator living on the device.  ``device`` None
    means CUDA, and raises without it.  ``optimizer``: an optimizer
    object, ``"adam8bit"`` (``optim8bit.adamw8bit()``, on a mesh built
    with it and the family's ``param_specs``) or None
    (``training.adamw(3e-4, weight_decay=0.1)``).

    ``mesh`` (a :class:`..parallel.mesh.Mesh`) shards the step over its
    ranks as the layout says: ``init_all`` keeps this rank's shards of the
    tree a seed gives at every world size (:meth:`Layout.draw`); ``step``
    takes this rank's rows of the batch (its coordinate along data x
    fsdp) and returns the global loss.  ``attn_fn``: the
    sequence-parallel attention over the seq axis
    (:func:`..parallel.ring.make_ring_attn_fn`,
    :func:`..parallel.ulysses.make_ulysses_attn_fn`)."""
    from .convert import model

    dev = resolve_device(device)
    if mesh is not None:
        check_mesh_step(dev, mesh, optimizer)
    lay = model(cfg).Layout(cfg, mesh, attn_fn)
    return training.make_train_step(
        lay.loss, lambda generator: lay.draw(generator, dev), optimizer,
        reduce_grads=lay.reduce_grads, reduce_loss=lay.reduce_loss,
        mesh=mesh, param_specs=lay.specs(),
    )
