"""Block-wise 8-bit AdamW: the moments stored in one byte per value.

Counterpart of ``tpu_network_operator/models/optim8bit.py`` on one device.
The layout is the reference's, so a state moves between the two packages
leaf by leaf (:func:`adam8_state_from_jax`):

* quantization blocks run along the LAST axis of each parameter, 256
  values per block when the last dim divides 256, one whole-row block
  otherwise (:func:`_leaf_block`); the codes ``q`` have exactly the
  parameter's shape and the f32 scales the parameter's leading shape plus
  a trailing block index (:class:`QTensor`);
* the first moment is linear symmetric int8 (scale = max|m| / 127), the
  second float8-e4m3 (scale = max|v| / 448), an all-zero block keeping
  scale 1.0;
* the Adam math runs in f32 as ``optax.adamw`` does, with the ratio
  clipped to ±:data:`RATIO_CLIP`.

The update of one leaf is one pass: dequantize, step the moments, form
the parameter update in the parameter's dtype and add it to the parameter
(``optax.apply_updates``), requantize the moments.  The parameters and the
moments are updated in place.  :func:`_leaf_update_plain` is that pass in
plain tensor code up to the update (the reference's jnp path, operation
for operation) and :func:`adam8_plain` adds it, leaf by leaf;
:func:`adam8_fused` is the hand-written CUDA kernel
``ops/csrc/adam8_fused.cu``, one launch for up to :data:`TABLE_LEAVES`
leaves, p written in place.  :class:`AdamW8bit` sends every CPU leaf
through the plain version and every CUDA leaf through one kernel call,
whatever its shape: there is no fallback and no switch.

Both versions divide by 127 and 448 (and by the bias corrections), as the
reference's source text and its jnp path do.  The reference's Pallas
kernel, run through XLA, multiplies by float32(1/127) instead, so its
scales may differ from these in the last bit (``tests/
test_torch_optim8bit.py`` pins it).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import _kernels
from .training import Tree, bias_corrections, tree_leaves, tree_map

BLOCK = 256
RATIO_CLIP = 10.0
_F8_MAX = 448.0   # float8_e4m3fn max finite
F8 = torch.float8_e4m3fn
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TABLE_LEAVES = 32   # leaves one kernel launch takes (the kernel's kMaxLeaves)


class QTensor(NamedTuple):
    """Block-quantized tensor, stored parameter-shaped.

    ``q``     -- int8 | float8_e4m3fn, exactly the source tensor's shape;
    ``scale`` -- f32, ``q.shape[:-1] + (q.shape[-1] // b,)`` with ``b``
                 from :func:`_leaf_block` (``(1,)`` for a 0-dim source).
    """

    q: torch.Tensor
    scale: torch.Tensor


def _leaf_block(last: int, block: int) -> int:
    """Per-leaf block length along the last axis: ``block`` when it
    divides evenly, else the whole row."""
    if last and block and last % block == 0:
        return block
    return max(last, 1)


def _rows(x: torch.Tensor, nb: int) -> torch.Tensor:
    """x as an f32 [..., nb, b] view, blocks along the last axis."""
    if x.dim() == 0:
        x = x.reshape(1)
    return x.float().reshape(*x.shape[:-1], nb, x.shape[-1] // nb)


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    last = x.shape[-1] if x.dim() else 1
    return _rows(x, last // _leaf_block(last, block))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true f32 division.  The divisor is a 0-dim tensor on x's
    device: CUDA PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal, which may differ in the last bit."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA and the kernel's
    ``__fsqrt_rn`` take it: CPU PyTorch's vectorized f32 sqrt is off by an
    ulp on a few values in a thousand.  The root of an f32 value taken in
    f64 and rounded once to f32 is the correctly rounded f32 root."""
    return torch.sqrt(x.double()).float()


def _row_quant_i8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 requant along the last axis (keepdims scales)."""
    scale = _div(rows.abs().amax(dim=-1, keepdim=True), 127.0)
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(rows / scale), -127, 127).to(torch.int8)
    return q, scale


def _row_quant_f8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float8-e4m3 requant along the last axis (second moment)."""
    scale = _div(rows.abs().amax(dim=-1, keepdim=True), _F8_MAX)
    scale = torch.where(scale == 0.0, 1.0, scale)
    return (rows / scale).to(F8), scale


def _pack(shape, q3: torch.Tensor, s3: torch.Tensor) -> QTensor:
    """[..., nb, b] codes + keepdims scales -> the stored form."""
    stored = tuple(shape) if shape else (1,)
    return QTensor(q=q3.reshape(shape),
                   scale=s3.reshape(*stored[:-1], -1))


def quantize(x: torch.Tensor, block: int = BLOCK) -> QTensor:
    """Linear symmetric int8 (for the centered first moment)."""
    return _pack(x.shape, *_row_quant_i8(_blocked(x, block)))


def quantize_f8(x: torch.Tensor, block: int = BLOCK) -> QTensor:
    """float8 e4m3 with per-block scale (for the wide-range second
    moment)."""
    return _pack(x.shape, *_row_quant_f8(_blocked(x, block)))


def dequantize(qt: QTensor, shape) -> torch.Tensor:
    """The f32 values of ``qt`` in ``shape``."""
    rows = _rows(qt.q, qt.scale.shape[-1]) * qt.scale[..., None]
    return rows.reshape(shape)


def _zero_q(p: torch.Tensor, qdtype: torch.dtype, block: int) -> QTensor:
    """quantize(zeros like p) built directly: codes 0, scales 1.0."""
    if p.dim() == 0:
        return QTensor(q=torch.zeros((), dtype=qdtype, device=p.device),
                       scale=torch.ones(1, dtype=torch.float32,
                                        device=p.device))
    b = _leaf_block(p.shape[-1], block)
    return QTensor(
        q=torch.zeros(p.shape, dtype=qdtype, device=p.device),
        scale=torch.ones(*p.shape[:-1], p.shape[-1] // b,
                         dtype=torch.float32, device=p.device),
    )


def moment_bytes(state: Mapping[str, Any]) -> int:
    """At-rest bytes of the quantized moments, codes and scales."""
    total = 0
    for qt in [*tree_leaves(state["m"]), *tree_leaves(state["v"])]:
        for t in qt:
            total += t.numel() * t.element_size()
    return total


# -- one leaf's update ---------------------------------------------------------


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(x))


class Consts(NamedTuple):
    """One step's scalars, each already rounded to f32 as the reference
    rounds a weak-typed Python float: ``omb1`` is f32(1.0 - b1) with the
    subtraction in double (0.1f, not 1.0f - 0.9f)."""

    b1: float
    omb1: float
    b2: float
    omb2: float
    eps: float
    wd: float
    neg_lr: float
    c1: float
    c2: float


def _moments_plain(g, m: QTensor, v: QTensor, k: Consts):
    """The stepped f32 moments [..., nb, b] of one leaf."""
    nb = m.scale.shape[-1]
    gf = _rows(g, nb)
    mf = _rows(m.q, nb) * m.scale[..., None]
    vf = _rows(v.q, nb) * v.scale[..., None]
    mf = mf * k.b1 + gf * k.omb1
    vf = vf * k.b2 + gf * k.omb2 * gf
    return mf, vf


def _leaf_update_plain(p: torch.Tensor, g: torch.Tensor, m: QTensor,
                       v: QTensor, k: Consts) -> torch.Tensor:
    """One leaf's update as the reference's jnp path computes it, in its
    order of operations, every op in f32 on its own (no fused
    multiply-add).  Requantizes ``m`` and ``v`` in place and returns the
    update in p's dtype and shape (:func:`adam8_plain` adds it to p)."""
    mf, vf = _moments_plain(g, m, v, k)
    den = _sqrt(_div(vf, k.c2)) + k.eps
    ratio = torch.clamp(_div(mf, k.c1) / den, -RATIO_CLIP, RATIO_CLIP)
    upd = (ratio + _rows(p, mf.shape[-2]) * k.wd) * k.neg_lr
    for qt, (q, s) in ((m, _row_quant_i8(mf)), (v, _row_quant_f8(vf))):
        qt.q.copy_(q.reshape(qt.q.shape))
        qt.scale.copy_(s.reshape(qt.scale.shape))
    return upd.to(p.dtype).reshape(p.shape)


def _check_kernel_inputs(p, g, m: QTensor, v: QTensor) -> None:
    """Validate one leaf for the kernel."""
    if p.device.type != "cuda":
        raise ValueError("the 8-bit AdamW kernel takes CUDA tensors")
    if p.dtype not in _DTYPE_CODES:
        raise TypeError(f"the 8-bit AdamW kernel takes float32/bfloat16 "
                        f"parameters, got {p.dtype}")
    tensors = (p, g, m.q, m.scale, v.q, v.scale)
    if any(t.device != p.device for t in tensors):
        raise ValueError("the 8-bit AdamW kernel takes tensors on one device")
    if g.shape != p.shape or g.dtype != p.dtype:
        raise ValueError(f"g must match p {tuple(p.shape)} {p.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if m.q.dtype != torch.int8 or v.q.dtype != F8 \
            or m.q.shape != p.shape or v.q.shape != p.shape:
        raise ValueError("the moments must be int8 (m) and float8_e4m3fn "
                         "(v) codes of the parameter's shape")
    stored = tuple(p.shape) if p.dim() else (1,)
    want = (*stored[:-1], m.scale.shape[-1] if m.scale.dim() else 0)
    if want[-1] == 0 or stored[-1] % want[-1] \
            or tuple(m.scale.shape) != want or tuple(v.scale.shape) != want \
            or m.scale.dtype != torch.float32 \
            or v.scale.dtype != torch.float32:
        raise ValueError(f"the scales must be float32 [..., blocks per "
                         f"row] for p {stored}, got {tuple(m.scale.shape)} "
                         f"and {tuple(v.scale.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the 8-bit AdamW kernel takes contiguous tensors")


Leaf = Tuple[torch.Tensor, torch.Tensor, QTensor, QTensor]   # (p, g, m, v)


def adam8_plain(leaves: Sequence[Leaf], k: Consts) -> None:
    """The plain version of :func:`adam8_fused`: each leaf's update
    (:func:`_leaf_update_plain`) added to p in p's dtype, as
    ``optax.apply_updates`` adds it.  Updates p, m and v in place."""
    for p, g, m, v in leaves:
        p.add_(_leaf_update_plain(p, g, m, v, k))


class LeafEntry(ctypes.Structure):
    """One leaf of a launch's table, laid out as ``csrc/adam8_fused.cu``'s
    ``Leaf`` (80 bytes)."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mq", ctypes.c_void_p), ("ms", ctypes.c_void_p),
                ("vq", ctypes.c_void_p), ("vs", ctypes.c_void_p),
                ("start", ctypes.c_longlong),  # its first block in the launch
                ("end", ctypes.c_longlong),    # one past its last block
                ("block", ctypes.c_int),       # values a block
                ("dtype", ctypes.c_int),       # _DTYPE_CODES
                ("vec", ctypes.c_int),         # 1: the register path
                ("pad", ctypes.c_int)]


def leaf_tables(leaves: Sequence[Leaf]) -> List[List[LeafEntry]]:
    """The kernel's launch tables for ``leaves``: every leaf that holds
    values, in order, at most :data:`TABLE_LEAVES` to a table, each
    table's blocks numbered from 0.  A leaf takes the register path where
    its blocks are 256 values long, p and g 16-byte aligned and the codes
    8-byte aligned, else the row loop."""
    tables: List[List[LeafEntry]] = []
    table: List[LeafEntry] = []
    start = 0
    for p, g, m, v in leaves:
        if p.numel() == 0:
            continue
        if len(table) == TABLE_LEAVES:
            tables.append(table)
            table, start = [], 0
        nb = m.scale.numel()
        block = p.numel() // nb
        vec = (block == 256 and p.data_ptr() % 16 == 0
               and g.data_ptr() % 16 == 0 and m.q.data_ptr() % 8 == 0
               and v.q.data_ptr() % 8 == 0)
        table.append(LeafEntry(
            p.data_ptr(), g.data_ptr(), m.q.data_ptr(), m.scale.data_ptr(),
            v.q.data_ptr(), v.scale.data_ptr(), start, start + nb, block,
            _DTYPE_CODES[p.dtype], int(vec)))
        start += nb
    if table:
        tables.append(table)
    return tables


def _check_disjoint(leaves: Sequence[Leaf]) -> None:
    """Refuse leaves whose tensors share memory: the kernel reads and
    rewrites each tensor of each leaf as its own."""
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
        for p, g, m, v in leaves for t in (p, g, *m, *v) if t.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("the 8-bit AdamW kernel takes leaves whose "
                             "tensors share no memory")


def adam8_fused(leaves: Sequence[Leaf], k: Consts) -> None:
    """The kernel (``csrc/adam8_fused.cu``): steps every leaf's p, m and v
    in place, one launch for each :data:`TABLE_LEAVES` leaves."""
    leaves = list(leaves)
    for leaf in leaves:
        _check_kernel_inputs(*leaf)
    if len({leaf[0].device for leaf in leaves}) > 1:
        raise ValueError("the 8-bit AdamW kernel takes leaves on one device")
    _check_disjoint(leaves)
    for table in leaf_tables(leaves):
        err = _kernels.lib().tpunet_adam8_fused(
            (LeafEntry * len(table))(*table), len(table), *k,
            _kernels.stream_handle(leaves[0][0].device))
        _kernels.check(err, "adam8_fused")
        _kernels.count_launch("adam8_fused")


# -- the optimizer ---------------------------------------------------------------


class AdamW8bit:
    """``adamw8bit``: AdamW with int8 / float8 moments, updating the
    parameters and the moments in place.

    ``init(params)`` -> ``{"count": 0, "m": tree of QTensor, "v": ...}``;
    ``apply(params, grads, state)`` steps every leaf of ``params`` by its
    gradient (``grads`` in :func:`.training.tree_leaves` order) and
    returns (params, state).  ``count`` is a host int, and the bias
    corrections reach the kernel by value, so a step never waits for the
    device."""

    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 block: int = BLOCK):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps, self.block = b1, b2, eps, block

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "m": tree_map(lambda p: _zero_q(p, torch.int8, self.block),
                              params),
                "v": tree_map(lambda p: _zero_q(p, F8, self.block), params)}

    def consts(self, count: int) -> Consts:
        c1, c2 = bias_corrections(self.b1, self.b2, count)
        return Consts(
            b1=_f32(self.b1), omb1=_f32(1.0 - self.b1),
            b2=_f32(self.b2), omb2=_f32(1.0 - self.b2),
            eps=_f32(self.eps), wd=_f32(self.weight_decay),
            neg_lr=_f32(-self.lr), c1=c1, c2=c2,
        )

    @torch.no_grad()
    def apply(self, params: Tree, grads, state) -> Tuple[Tree, Dict]:
        if params is None:
            raise ValueError("adamw8bit requires params (weight decay)")
        count = state["count"] + 1
        k = self.consts(count)
        leaves = list(zip(tree_leaves(params), grads,
                          tree_leaves(state["m"]), tree_leaves(state["v"])))
        cuda = [leaf for leaf in leaves if leaf[0].device.type == "cuda"]
        if cuda:
            adam8_fused(cuda, k)
        adam8_plain([leaf for leaf in leaves
                     if leaf[0].device.type != "cuda"], k)
        state["count"] = count
        return params, state


def adamw8bit(learning_rate: float = 3e-4, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.1, block: int = BLOCK) -> AdamW8bit:
    """The reference's ``adamw8bit`` with its defaults."""
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, block)


def adam8_state_from_jax(state: Any, device=None) -> Dict[str, Any]:
    """A JAX ``Adam8State`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as this module's state on ``device``, bit for bit.  The codes
    cross through a uint8 view: ``torch.from_numpy`` rejects ml_dtypes'
    float8 as it rejects bfloat16."""
    dev = resolve_device(device)
    qdtypes = {"int8": torch.int8, "float8_e4m3fn": F8}

    def code(a) -> torch.Tensor:
        a = np.array(a, copy=True, order="C")
        return torch.from_numpy(a.view(np.uint8)).view(
            qdtypes[a.dtype.name]).to(dev)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(x) for k, x in node.items()}
        scale = np.array(node.scale, dtype=np.float32, copy=True, order="C")
        return QTensor(q=code(node.q), scale=torch.from_numpy(scale).to(dev))

    return {"count": int(np.asarray(state.count)), "m": walk(state.m),
            "v": walk(state.v)}
