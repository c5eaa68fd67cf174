"""Block-wise 8-bit AdamW: the moments stored in one byte per value.

Counterpart of ``tpu_network_operator/models/optim8bit.py``.  The layout
is the reference's, so a state moves between the two packages leaf by
leaf (:func:`adam8_state_from_jax`):

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

On a mesh (``adamw8bit(mesh=, param_specs=)``) each rank steps its shards
of the global tree, and its state is its slice of the single-device state
of that tree, the scales included (:func:`mesh_leaf_plan`): a leaf whose
shards cut no quantization block steps its shard where it lies, and one
whose last-dim shards would cut blocks steps the global blocks on rows
gathered over the axis that cuts them, keeping its scales whole along
that axis.  Either way the bits are the single-device update's.

Both versions divide by 127 and 448 (and by the bias corrections), as the
reference's source text and its jnp path do.  The reference's Pallas
kernel, run through XLA, multiplies by float32(1/127) instead, so its
scales may differ from these in the last bit (``tests/
test_torch_optim8bit.py`` pins it).
"""

from __future__ import annotations

import ctypes
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from .. import resolve_device
from ..ops import _kernels
from ..parallel import comm
from ..parallel.mesh import global_shape
from .training import (Tree, bias_corrections, map_by_name, tree_leaves,
                       tree_map)

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


def _zero_q(p: torch.Tensor, qdtype: torch.dtype, block: int,
            last: Optional[int] = None) -> QTensor:
    """quantize(zeros like p) built directly: codes 0, scales 1.0.
    ``last``: the length of the rows the blocks are cut from (p's last
    dim; on the global-block path of a mesh, the global last dim)."""
    if p.dim() == 0:
        return QTensor(q=torch.zeros((), dtype=qdtype, device=p.device),
                       scale=torch.ones(1, dtype=torch.float32,
                                        device=p.device))
    last = p.shape[-1] if last is None else last
    return QTensor(
        q=torch.zeros(p.shape, dtype=qdtype, device=p.device),
        scale=torch.ones(*p.shape[:-1], last // _leaf_block(last, block),
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


# -- on a mesh ------------------------------------------------------------------


def mesh_leaf_plan(mesh, spec, shape, block: int = BLOCK) -> Optional[str]:
    """Where one leaf of global ``shape``, sharded by ``spec`` over
    ``mesh``, takes its update: None where each rank steps its own shard,
    because the shard's quantization blocks are the global blocks; else
    the mesh axis over whose ranks the leaf's rows are gathered to step
    the global blocks (the reference's ``_mesh_leaf_plan``, without the
    TPU's 32-row tiling, which the CUDA kernel does not need).

    Blocks run along the last axis, so only the axis that shards the last
    dim can cut one: a leaf steps per shard when its last dim is whole on
    every rank or its local last dim is a multiple of ``block``.  So
    whole-row blocks split over an axis, and ``block``-blocks whose shard
    is not a whole number of them, take the gather."""
    if mesh is None or not shape:
        return None
    axis = spec[-1]
    if axis is None or mesh.size(axis) == 1:
        return None
    if (shape[-1] // mesh.size(axis)) % block == 0:
        return None
    return axis


def update_shards(leaves: Sequence[Leaf], plans: Sequence[Optional[str]],
                  k: Consts, gather: Callable, coord) -> None:
    """One rank's step of its shards, in place: ``plans`` gives each
    leaf's :func:`mesh_leaf_plan`.  A per-shard leaf steps as it lies; a
    global-block leaf steps its rows gathered along the last dim over its
    axis (``gather(x, axis)``: the shards of every rank along ``axis``,
    concatenated in order), its scales being the global blocks' already,
    and keeps this rank's slice (``coord``: a mesh or a
    :class:`..parallel.mesh.MeshCoord`).  Every leaf goes through one
    :func:`adam8_fused` call where it lies on CUDA, through
    :func:`adam8_plain` on the CPU."""
    run, back = [], []
    for (p, g, m, v), axis in zip(leaves, plans):
        if axis is None:
            run.append((p, g, m, v))
            continue
        whole = (gather(p, axis), gather(g, axis),
                 QTensor(gather(m.q, axis), m.scale),
                 QTensor(gather(v.q, axis), v.scale))
        run.append(whole)
        back.append(((p, m.q, v.q), whole, axis))
    cuda = [leaf for leaf in run if leaf[0].device.type == "cuda"]
    if cuda:
        adam8_fused(cuda, k)
    adam8_plain([leaf for leaf in run if leaf[0].device.type != "cuda"], k)
    for local, (p, _, m, v), axis in back:
        i, n = coord.coord[axis], coord.size(axis)
        for dst, src in zip(local, (p, m.q, v.q)):
            dst.copy_(src.chunk(n, dim=-1)[i])


def update_virtual_ranks(ranks: Sequence[Tuple[Any, Sequence[Leaf],
                                              Sequence[Optional[str]]]],
                         k: Consts) -> None:
    """The mesh's step for every rank of one plan, in one process with no
    process group: ``ranks`` holds each rank's (``MeshCoord``, leaves,
    plans), every rank of the plan once.  Each rank runs
    :func:`update_shards`, its global-block leaves on rows concatenated
    from the shards of the ranks along their axis as they were before the
    step, which is what the all-gather gives each rank on a mesh.  The
    seam that the card's check of the sharded update drives."""
    index = {tuple(c.coord.values()): r for r, (c, _, _) in enumerate(ranks)}
    before = [{i: (p.clone(), g, m.q.clone(), v.q.clone())
               for i, ((p, g, m, v), axis) in enumerate(zip(leaves, plans))
               if axis is not None} for _, leaves, plans in ranks]
    for coord, leaves, plans in ranks:
        rows = {}
        for i, ((p, g, m, v), axis) in enumerate(zip(leaves, plans)):
            if axis is None:
                continue
            peers = [index[tuple(j if a == axis else c
                                 for a, c in coord.coord.items())]
                     for j in range(coord.size(axis))]
            for t, shards in zip((p, g, m.q, v.q),
                                 zip(*(before[q][i] for q in peers))):
                rows[t.data_ptr()] = torch.cat(shards, dim=-1)
        update_shards(leaves, plans, k,
                      lambda x, axis: rows[x.data_ptr()], coord)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The shards of ``x`` of every rank of ``group`` concatenated along
    the last dim, in rank order; one-byte codes cross as their raw bytes
    (float8 is not a collective dtype everywhere)."""
    if x.element_size() == 1:
        return comm.all_gather(x.view(torch.uint8), group, -1).view(x.dtype)
    return comm.all_gather(x, group, -1)


# -- the optimizer ---------------------------------------------------------------


class AdamW8bit:
    """``adamw8bit``: AdamW with int8 / float8 moments, updating the
    parameters and the moments in place.

    ``init(params)`` -> ``{"count": 0, "m": tree of QTensor, "v": ...}``;
    ``apply(params, grads, state)`` steps every leaf of ``params`` by its
    gradient (``grads`` in :func:`.training.tree_leaves` order) and
    returns (params, state).  ``count`` is a host int, and the bias
    corrections reach the kernel by value, so a step never waits for the
    device.

    With ``mesh`` and ``param_specs`` (the model's, paired with the leaves
    by name), ``params`` are this rank's shards, and ``init`` and
    ``apply`` keep this rank's slice of the single-device state of the
    global tree (:func:`update_shards`)."""

    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 block: int = BLOCK, mesh=None, param_specs=None):
        if mesh is not None and param_specs is None:
            raise ValueError("adamw8bit on a mesh needs the param_specs")
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps, self.block = b1, b2, eps, block
        self.mesh, self.param_specs = mesh, param_specs

    def plans(self, params: Tree) -> Tree:
        """Each leaf's :func:`mesh_leaf_plan` (all None off a mesh)."""
        if self.mesh is None:
            return tree_map(lambda p: None, params)
        return map_by_name(params, self.param_specs, lambda p, spec:
                           mesh_leaf_plan(self.mesh, spec, global_shape(
                               p.shape, spec, self.mesh.plan), self.block))

    def init(self, params: Tree) -> Dict[str, Any]:
        def zeros(qdtype):
            def one(p, axis):
                last = None if axis is None else (
                    p.shape[-1] * self.mesh.size(axis))
                return _zero_q(p, qdtype, self.block, last)
            return map_by_name(params, self.plans(params), one)

        return {"count": 0, "m": zeros(torch.int8), "v": zeros(F8)}

    def state_specs(self, params: Tree, param_specs: Tree) -> Dict[str, Any]:
        """The mesh specs of ``init(params)``'s leaves (``params`` this
        rank's shards of ``param_specs``): the codes take their
        parameter's spec, and so do the scales, but for the last dim of a
        global-block leaf's, which is whole; ``count``, a host int,
        None."""
        def one(spec, axis):
            spec = tuple(spec)
            return QTensor(q=spec, scale=spec if axis is None
                           else spec[:-1] + (None,))

        specs = map_by_name(param_specs, self.plans(params), one)
        return {"count": None, "m": specs, "v": specs}

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
        leaves = list(zip(tree_leaves(params), grads,
                          tree_leaves(state["m"]), tree_leaves(state["v"])))
        mesh = self.mesh
        update_shards(leaves, list(tree_leaves(self.plans(params))),
                      self.consts(count),
                      lambda x, axis: gather_last(x, mesh.group(axis)), mesh)
        state["count"] = count
        return params, state


def adamw8bit(learning_rate: float = 3e-4, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.1, block: int = BLOCK, mesh=None,
              param_specs=None) -> AdamW8bit:
    """The reference's ``adamw8bit`` with its defaults; ``mesh`` (a
    :class:`..parallel.mesh.Mesh`) and ``param_specs`` step each rank's
    shards of the global tree."""
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, block, mesh,
                     param_specs)


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
