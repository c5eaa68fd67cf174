"""The train step: loss math, remat policies, AdamW.

Counterpart of ``tpu_network_operator/models/training.py``.
:func:`make_train_step` keeps the reference's contract (``step(params,
opt_state, tokens) -> (params, opt_state, loss)``), and updates the
parameters and the moments in place, which is what the reference's
donation of both buffers buys on the TPU.  On a mesh the model's layout
supplies the gradient and loss reductions (``models/llama.py``
``Layout``); the optimizer steps each rank's shards as they are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import (Callable, Dict, Iterable, Iterator, List, Mapping,
                    NamedTuple, Optional, Sequence, Tuple)

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .. import tracing
from ..ops import _kernels
from ..ops.norms import rms_norm
from ..parallel import comm

REMAT_POLICIES = ("dots", "ffn", "ffn_lite", "ffn_offload", "full")
# the FFN intermediates each named policy keeps beside the post-attention
# residual (the tensors the reference tags in llama._layer):
# "ffn_gate" is rms_norm(resid_mid) @ w_gate, "ffn_up" the same @ w_up;
# "ffn_offload" keeps "ffn"'s set in pinned host memory (HostStash)
SAVED_FFN = {"ffn": ("ffn_gate", "ffn_up"), "ffn_lite": ("ffn_gate",),
             "ffn_offload": ("ffn_gate", "ffn_up")}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


# -- remat --------------------------------------------------------------------


def _save_ops(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` with the reference's named
    policy (``training.remat_policy``):

    * ``full``: save nothing but the inputs, recompute the rest;
    * ``dots``: save every matmul output (``dots_saveable``);
    * ``ffn`` / ``ffn_lite`` / ``ffn_offload``: save the tensors ``fn``
      tags with those names, of which a whole function has none, so
      nothing is saved, as under the reference's ``save_only_these_names``
      for a layer that tags nothing (the MoE layer).  The dense layer
      keeps its named tensors by splitting itself at them
      (:func:`swiglu_residual`).

    The recompute replays ``fn`` up to the last tensor its backward
    needs."""
    if policy in ("full", *SAVED_FFN):
        context_fn = None
    elif policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_ops(_MATMULS))
    else:
        raise ValueError(
            f"unknown remat_policy {policy!r}; choose from {REMAT_POLICIES}"
        )

    def wrapped(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


class HostStash:
    """Activations kept in pinned host memory from a forward to its
    backward: the "ffn_offload" policy's store, one per forward pass.

    :meth:`put` copies a layer's tensors to pinned host buffers on a side
    stream that first waits for the tensors' producers, so the copies
    overlap the forward's later work; the device tensors are marked in use
    by that stream, so their memory is not reused before the copy ends.
    :meth:`take` returns a layer's tensors on the device and starts the
    copy of the layer before it (the next one the backward asks for) on
    the side stream, so the backward's own work hides it; the current
    stream waits for a copy's event only where it reads the result.  The
    bytes move unchanged, so the gradients are those of keeping the
    tensors on the device."""

    def __init__(self):
        self.host = []              # per put(): the pinned copies
        self.stream = None
        self._fetched = {}          # key -> (device tensors, ready event)

    def put(self, tensors) -> int:
        """Copy ``tensors`` (CUDA) to pinned host memory; returns their
        key, 0, 1, ... in the order of the calls."""
        cur = torch.cuda.current_stream()
        if self.stream is None:
            self.stream = torch.cuda.Stream(cur.device)
        self.stream.wait_stream(cur)
        host = []
        with torch.cuda.stream(self.stream):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
                host.append(h)
        self.host.append(host)
        return len(self.host) - 1

    def _fetch(self, key: int):
        cur = torch.cuda.current_stream()
        # allocated on the current stream, which the copy waits for: the
        # memory's earlier users have finished with it
        outs = [torch.empty(h.shape, dtype=h.dtype, device=cur.device)
                for h in self.host[key]]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for o, h in zip(outs, self.host[key]):
                o.copy_(h, non_blocking=True)
        return outs, self.stream.record_event()

    def take(self, key: int):
        """The tensors :meth:`put` stored under ``key``, on the device,
        ready for the current stream."""
        outs, ready = self._fetched.pop(key, None) or self._fetch(key)
        if key > 0 and key - 1 not in self._fetched:
            self._fetched[key - 1] = self._fetch(key - 1)
        torch.cuda.current_stream().wait_event(ready)
        return outs


class _SwiGLUResidual(torch.autograd.Function):
    """x + (silu(gate) * up) @ w_down with y = rms_norm(x, ln), gate =
    y @ w_gate and up = y @ w_up, saving x, gate and (``save_up``) up: the
    "ffn" / "ffn_lite" save set of the dense layer's FFN half, which with
    a ``stash`` (:class:`HostStash`, CUDA tensors) waits in pinned host
    memory instead of on the device ("ffn_offload").  The backward
    recomputes y (the RMSNorm forward) and silu(gate) * up, and under
    "ffn_lite" up, and reruns no other product: the gradient GEMMs are the
    ones autograd runs, with the same operands in the same layouts, so the
    gradients are remat=False's bits."""

    @staticmethod
    def forward(ctx, x, ln, w_gate, w_up, w_down, eps, save_up, stash,
                group):
        y = rms_norm(x, ln, eps)
        gate = y @ w_gate
        up = y @ w_up
        out = x + comm.all_reduce(
            (torch.nn.functional.silu(gate) * up) @ w_down, group)
        ctx.eps, ctx.stash, ctx.group = eps, stash, group
        if stash is not None:
            ctx.key = stash.put((x, gate, up))
            ctx.save_for_backward(ln, w_gate, w_up, w_down)
        else:
            ctx.save_for_backward(ln, w_gate, w_up, w_down, x, gate,
                                  up if save_up else None)
        return out

    @staticmethod
    def backward(ctx, g):
        ln, w_gate, w_up, w_down, *acts = ctx.saved_tensors
        x, gate, up = (acts if ctx.stash is None
                       else ctx.stash.take(ctx.key))
        with torch.enable_grad():
            xd, lnd = x.detach().requires_grad_(), ln.detach().requires_grad_()
            y = rms_norm(xd, lnd, ctx.eps)
        y2 = y.detach().reshape(-1, y.shape[-1])
        if up is None:
            up = (y2 @ w_up).view(gate.shape)
        with torch.enable_grad():
            gd, ud = gate.detach().requires_grad_(), up.detach().requires_grad_()
            h = torch.nn.functional.silu(gd) * ud
        g2 = g.reshape(-1, g.shape[-1])
        dh = g2.mm(w_down.t())
        dw_down = h.detach().reshape(-1, h.shape[-1]).t().mm(g2)
        dgate, dup = torch.autograd.grad(h, (gd, ud), dh.view(h.shape))
        dgate2, dup2 = (t.reshape(-1, t.shape[-1]) for t in (dgate, dup))
        dy = comm.all_reduce(dgate2.mm(w_gate.t()) + dup2.mm(w_up.t()),
                             ctx.group)
        dx, dln = torch.autograd.grad(y, (xd, lnd), dy.view(y.shape))
        return (g + dx, dln, y2.t().mm(dgate2), y2.t().mm(dup2), dw_down,
                None, None, None, None)


def swiglu_residual(x: torch.Tensor, ln: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, eps: float,
                    policy: str, stash: HostStash = None,
                    group=None) -> torch.Tensor:
    """The dense layer's FFN half, x + SwiGLU(rms_norm(x, ln)), keeping
    :data:`SAVED_FFN` ``[policy]`` for its backward (see
    :class:`_SwiGLUResidual`): under "ffn_offload", in ``stash``'s pinned
    host memory when ``x`` is a CUDA tensor, and on the device as "ffn"
    otherwise (the reference keeps them in device memory off the TPU).

    ``group``: the tensor-parallel group whose ranks hold column shards of
    ``w_gate`` / ``w_up`` and row shards of ``w_down``; the down
    projection is then a partial sum, all-reduced before the residual
    add, and so is the gradient of the normed input (Megatron's g and f
    around the pair)."""
    offload = policy == "ffn_offload" and x.is_cuda
    return _SwiGLUResidual.apply(x, ln, w_gate, w_up, w_down, eps,
                                 "ffn_up" in SAVED_FFN[policy],
                                 stash if offload else None, group)


# -- loss ---------------------------------------------------------------------


class _LogitsF32(torch.autograd.Function):
    """x @ w with f32 output from operands in their own dtype (bf16 on the
    model path), as ``einsum(..., preferred_element_type=f32)`` computes
    the reference's vocab projection: the products accumulate in f32 and
    no logit is rounded to bf16.

    On CUDA the forward is one tensor-core GEMM with an f32 output
    (``torch.mm(..., out_dtype=float32)``, which has no autograd formula of
    its own); on the CPU the operands are widened to f32 first, which is
    exact.  The backward rounds the f32 logits cotangent to the operands'
    dtype once and runs the two GEMMs on it with f32 accumulation (what
    the TPU's default matmul precision does with f32 operands); an f32
    GEMM on the card would run without tensor cores.  In f32 models the
    rounding is the identity."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.device.type == "cuda":
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        if x2.device.type == "cuda":
            return g @ w.t(), x2.t() @ g
        g32 = g.float()
        return ((g32 @ w.float().t()).to(x2.dtype),
                (x2.float().t() @ g32).to(w.dtype))


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H] @ w [H, V] -> f32 logits [..., V] (see :class:`_LogitsF32`)."""
    out = _LogitsF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def next_token_xent(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy.  logits [B,S,V] f32, tokens [B,S+1]."""
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def _chunk_loss(xc, lm_head, tc):
    logits = logits_f32(xc, lm_head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None])[..., 0]
    return (logz - gold).sum()


def chunked_next_token_xent(
    x: torch.Tensor,          # [B, S, H] final hidden states
    lm_head: torch.Tensor,    # [H, V]
    tokens: torch.Tensor,     # [B, S+1]
    chunk: int,
) -> torch.Tensor:
    """Next-token xent that never holds the full [B, S, V] logits: the
    vocab projection and softmax run per sequence chunk, each chunk under
    its own checkpoint, so the backward recomputes one chunk's f32 logits
    at a time and the peak is [B, chunk, V]."""
    targets = tokens[:, 1:].long()
    b, s, _ = x.shape
    n = s // chunk
    if n * chunk != s:
        raise ValueError(f"seq {s} not divisible by xent chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, x[:, sl], lm_head,
                                   targets[:, sl], use_reentrant=False)
    return total / (b * s)


# -- AdamW --------------------------------------------------------------------

Tree = Dict[str, object]


def tree_leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def map_by_name(tree: Tree, specs: Tree, fn: Callable) -> Tree:
    """``fn(leaf, spec)`` over ``tree``, each leaf paired with the entry of
    ``specs`` at its key path (never by position: trees from JAX come in
    sorted key order, the model's specs in declaration order)."""
    return {k: map_by_name(v, specs[k], fn) if isinstance(v, Mapping)
            else fn(v, specs[k]) for k, v in tree.items()}


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 - b1^count, 1 - b2^count) in f32, as host floats.  The power is
    an f32 ``pow`` of two tensors, as the reference's ``b ** count`` in f32
    computes it: ``tensor ** int`` multiplies instead (``x * x * x`` for 3),
    which moves 1 - 0.999^3 by 2e-5 of itself."""
    one = torch.tensor(1.0, dtype=torch.float32)
    n = torch.tensor(float(count), dtype=torch.float32)
    return tuple(
        (one - torch.pow(torch.tensor(b, dtype=torch.float32), n)).item()
        for b in (b1, b2))


class AdamWConsts(NamedTuple):
    """One step's constants for the leaves of one dtype, each a host float
    that is a value of that dtype (see :class:`AdamW`): b1, 1 - b1, b2,
    1 - b2, the bias corrections c1 and c2, eps, the weight decay and
    -lr."""

    b1: float
    omb1: float
    b2: float
    omb2: float
    c1: float
    c2: float
    eps: float
    wd: float
    neg_lr: float


AdamWLeaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (p, g, m, v)


def adamw_plain(leaves: Sequence[AdamWLeaf],
                consts: Mapping[torch.dtype, AdamWConsts]) -> None:
    """The plain version of :func:`adamw_fused`: each leaf stepped in place
    by eager elementwise ops, with ``consts`` of the leaf's dtype."""
    for p, g, m, v in leaves:
        k = consts[p.dtype]
        m.mul_(k.b1).add_(g * k.omb1)
        v.mul_(k.b2).add_(torch.square(g) * k.omb2)
        m_hat = m / k.c1
        v_hat = v / k.c2
        u = m_hat / (torch.sqrt(v_hat) + k.eps)
        u = u + k.wd * p
        p.add_(u * k.neg_lr)


# the kernel's dtype codes (csrc/adamw_fused.cu), the order of its constants
ADAMW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ADAMW_TABLE_LEAVES = 64   # leaves one launch takes (the kernel's kMaxLeaves)


class AdamWLeafEntry(ctypes.Structure):
    """One leaf of a launch's table, laid out as ``csrc/adamw_fused.cu``'s
    ``Leaf`` (56 bytes)."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("start", ctypes.c_longlong),  # its first 16-byte unit
                ("n", ctypes.c_longlong),      # values
                ("dtype", ctypes.c_int),       # ADAMW_DTYPES
                ("vec", ctypes.c_int)]         # 1: all four 16-byte aligned


def _check_adamw_leaf(p, g, m, v) -> None:
    if p.dtype not in ADAMW_DTYPES:
        raise TypeError(f"adamw_fused takes float32, bfloat16 or float16 "
                        f"parameters, got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.dtype != p.dtype or t.shape != p.shape or t.device != p.device:
            raise ValueError(
                f"adamw_fused takes {name} of p's dtype, shape and device "
                f"({p.dtype} {tuple(p.shape)} {p.device}), got {t.dtype} "
                f"{tuple(t.shape)} {t.device}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw_fused takes contiguous tensors")


def _check_adamw_disjoint(leaves: Sequence[AdamWLeaf]) -> None:
    """Refuse leaves whose tensors share memory: the kernel reads every
    tensor of a leaf and rewrites p, m and v as their own."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for leaf in leaves for t in leaf if t.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("adamw_fused takes leaves whose tensors share "
                             "no memory")


def adamw_tables(leaves: Sequence[AdamWLeaf]) -> List[List[AdamWLeafEntry]]:
    """The kernel's launch tables for ``leaves``: every leaf that holds
    values, in order, at most :data:`ADAMW_TABLE_LEAVES` to a table, each
    table's 16-byte units (4 values in float32, 8 in 16 bits) numbered
    from 0.  A leaf whose four tensors are 16-byte aligned takes vector
    loads; any other, and a leaf's short last unit, a scalar loop."""
    tables: List[List[AdamWLeafEntry]] = []
    table: List[AdamWLeafEntry] = []
    start = 0
    for p, g, m, v in leaves:
        n = p.numel()
        if n == 0:
            continue
        if len(table) == ADAMW_TABLE_LEAVES:
            tables.append(table)
            table, start = [], 0
        vec = all(t.data_ptr() % 16 == 0 for t in (p, g, m, v))
        table.append(AdamWLeafEntry(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                    v.data_ptr(), start, n,
                                    ADAMW_DTYPES[p.dtype], int(vec)))
        start += -(-n * p.element_size() // 16)
    if table:
        tables.append(table)
    return tables


def _kernel_consts(consts: Mapping[torch.dtype, AdamWConsts]):
    """The kernel's constants: for each of its dtypes, nine f32 values
    (zeros for a dtype absent here), the bias corrections as their f32
    reciprocals, since a tensor divided by a host scalar is a product with
    the scalar's f32 reciprocal on the card (``div_true_kernel_cuda``)."""
    vals = []
    for dtype in ADAMW_DTYPES:
        k = consts.get(dtype)
        if k is None:
            vals += [0.0] * len(AdamWConsts._fields)
            continue
        one = np.float32(1.0)
        vals += [k.b1, k.omb1, k.b2, k.omb2, float(one / np.float32(k.c1)),
                 float(one / np.float32(k.c2)), k.eps, k.wd, k.neg_lr]
    return (ctypes.c_float * len(vals))(*vals)


def adamw_fused(leaves: Sequence[AdamWLeaf],
                consts: Mapping[torch.dtype, AdamWConsts]) -> None:
    """The kernel (``csrc/adamw_fused.cu``): steps every leaf's p, m and v
    in place, the bits of :func:`adamw_plain` on the card, one launch for
    each :data:`ADAMW_TABLE_LEAVES` leaves.  Counts the values it stepped
    under ``optim.adamw_fused_elems`` (:mod:`..tracing`)."""
    leaves = list(leaves)
    for leaf in leaves:
        _check_adamw_leaf(*leaf)
    _check_adamw_disjoint(leaves)
    devices = {leaf[0].device for leaf in leaves}
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"adamw_fused takes CUDA tensors, got {devices}")
    if len(devices) > 1:
        raise ValueError("adamw_fused takes leaves on one device")
    kc = _kernel_consts(consts)
    for table in adamw_tables(leaves):
        err = _kernels.lib().tpunet_adamw_fused(
            (AdamWLeafEntry * len(table))(*table), len(table), kc,
            _kernels.stream_handle(leaves[0][0].device))
        _kernels.check(err, "adamw_fused")
        _kernels.count_launch("adamw_fused")
    tracing.count("optim.adamw_fused_elems",
                  lambda: torch.tensor(sum(p.numel() for p, *_ in leaves)))


class AdamW:
    """``optax.adamw``, updating in place.

    Same defaults (b1 0.9, b2 0.999, eps 1e-8, decay on every leaf),
    moments in the parameter dtype, and optax's order of operations:
    moments, bias correction, m̂ / (√v̂ + eps), + wd · p, × −lr, then
    p + u in p's dtype.  Every Python constant meets a tensor in that
    tensor's dtype, as JAX casts a weak-typed scalar (so in bf16, b2
    = 0.999 is 1.0 and 1 − b1 is 0.10009765625, as under optax), and the
    bias corrections 1 − βᵗ are taken in f32 before the cast.

    :meth:`apply` steps CUDA leaves through :func:`adamw_fused`, one
    launch for the tree, and CPU leaves through :func:`adamw_plain`,
    which the kernel computes bit for bit on the card."""

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> Dict[str, object]:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def state_specs(self, params: Tree, param_specs: Tree) -> Dict[str, object]:
        """The mesh specs of ``init(params)``'s leaves (``params`` this
        rank's shards of ``param_specs``): each moment its parameter's;
        ``count``, a host int, None."""
        return {"count": None, "mu": param_specs, "nu": param_specs}

    def consts(self, count: int,
               dtypes: Iterable[torch.dtype]) -> Dict[torch.dtype, AdamWConsts]:
        """Step ``count``'s constants for each of ``dtypes``: each Python
        constant rounded to the dtype through float64, the bias
        corrections taken once in f32 before that."""
        bc1, bc2 = bias_corrections(self.b1, self.b2, count)
        raw = (self.b1, 1 - self.b1, self.b2, 1 - self.b2, bc1, bc2,
               self.eps, self.weight_decay, -self.lr)
        return {dt: AdamWConsts(*torch.tensor(raw, dtype=torch.float64)
                                .to(dt).tolist())
                for dt in dtypes}

    @torch.no_grad()
    def apply(self, params: Tree, grads, state) -> Tuple[Tree, Dict]:
        """Step every leaf of ``params`` by its gradient (``grads`` in
        :func:`tree_leaves` order) and return (params, state), both
        updated in place."""
        count = state["count"] + 1
        leaves = list(zip(tree_leaves(params), grads,
                          tree_leaves(state["mu"]),
                          tree_leaves(state["nu"])))
        consts = self.consts(count, {p.dtype for p, *_ in leaves})
        cuda = [leaf for leaf in leaves if leaf[0].is_cuda]
        if cuda:
            adamw_fused(cuda, consts)
        adamw_plain([leaf for leaf in leaves if not leaf[0].is_cuda], consts)
        state["count"] = count
        return params, state


def adamw(lr: float = 3e-4, weight_decay: float = 0.1, **kw) -> AdamW:
    return AdamW(lr, weight_decay, **kw)


# -- train step ---------------------------------------------------------------


def resolve_optimizer(optimizer, mesh=None, param_specs=None):
    """The optimizer object a train step takes: ``"adam8bit"`` is
    ``adamw8bit()`` with the library defaults, on ``mesh`` with
    ``param_specs`` (as the reference's ``make_sharded_train_step`` wires
    it); None is ``adamw(3e-4, weight_decay=0.1)``; an object as it is."""
    if optimizer == "adam8bit":
        from .optim8bit import adamw8bit

        return adamw8bit(mesh=mesh, param_specs=param_specs)
    return optimizer or adamw(3e-4, weight_decay=0.1)


def make_train_step(
    loss_fn: Callable,             # (params, tokens) -> scalar loss
    init_fn: Callable,             # generator -> params
    optimizer=None,
    reduce_grads: Optional[Callable] = None,
    reduce_loss: Optional[Callable] = None,
    mesh=None,
    param_specs=None,
):
    """(step, init_all, optimizer) with the reference's contract:
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``, the
    parameters and moments updated in place (the single-device
    counterpart of donating both); ``init_all(generator) -> (params,
    opt_state)``.  ``optimizer`` is an :class:`AdamW`, an
    :class:`.optim8bit.AdamW8bit`, ``"adam8bit"`` (``adamw8bit()`` with the
    library defaults, on ``mesh`` with ``param_specs``, as the reference's
    ``make_sharded_train_step`` wires it) or None (``adamw(3e-4,
    weight_decay=0.1)``).

    On a mesh, ``loss_fn`` gives this rank's share of the loss,
    ``reduce_grads(params, grads)`` sums the gradients (in
    :func:`tree_leaves` order) over the ranks that share each leaf before
    the update, and
    ``reduce_loss`` sums the returned loss over the ranks that split the
    batch; both are None on one device."""
    optimizer = resolve_optimizer(optimizer, mesh, param_specs)

    def step(params, opt_state, tokens):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        with tracing.span("train.forward"):
            loss = loss_fn(params, tokens)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
            if reduce_grads is not None:
                grads = reduce_grads(params, grads)
        with tracing.span("train.optimizer"):
            params, opt_state = optimizer.apply(params, grads, opt_state)
        loss = loss.detach()
        return params, opt_state, (loss if reduce_loss is None
                                   else reduce_loss(loss))

    def init_all(generator: torch.Generator):
        params = init_fn(generator)
        return params, optimizer.init(params)

    return step, init_all, optimizer
