"""Collective benchmarks and the planned DCN all-reduce over
torch.distributed.

Counterpart of ``tpu_network_operator/parallel/collectives.py``: the
all-reduce / all-gather / reduce-scatter / ppermute sweep over one mesh
axis that validates the network the operator provisioned, reporting
algorithmic and bus bandwidth, and the gradient all-reduce over the DCN
axis decomposed as the operator's plan hints (ring or hierarchical).
The reference's collectives are XLA's inside ``shard_map``; here they are
``torch.distributed`` calls on the axis's process group: NCCL on the GPU,
gloo on the CPU.

Each collective runs on the axis's own group
(:meth:`..mesh.Mesh.process_group`), also where the axis spans one rank,
so a world of one launches NCCL and nothing is timed as a Python no-op.
gloo cannot pair a rank with itself, so ``ppermute`` over an axis of one
rank runs on NCCL only.

**The size convention is the reference's**, not nccl-tests': ``size_bytes``
is the whole array of ``n_elems`` values.  ``all_reduce`` and ``ppermute``
start from it sharded over the axis (each rank sums, or sends, its
``n_elems / n`` block), ``reduce_scatter`` from the whole array on every
rank, and ``all_gather`` ends with it.  For ``all_reduce`` and
``ppermute`` the algorithmic and bus bandwidths are thus ``n`` times
nccl-tests' for the same per-rank buffer.

``all_reduce`` sums in place, as ``torch.distributed.all_reduce`` does: a
timed loop sums the same buffer again at each call, which moves the same
bytes, and the ring's one all-reduce pays no copy the hierarchical form
does not.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .comm import ring_hop

OPS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")


@dataclass
class CollectiveResult:
    op: str
    axis: str
    size_bytes: int          # global payload per device-visible array
    seconds: float           # best-of-iters wall time
    algbw_gbps: float        # size / time
    busbw_gbps: float        # hardware-normalized (ring-model) bandwidth

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


def _bus_factor(op: str, n: int) -> float:
    """Ring-model bus/algorithmic bandwidth ratio (nccl-tests convention)."""
    if n <= 1:
        return 1.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    return 1.0   # ppermute / p2p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn: Callable, arg: torch.Tensor, iters: int,
           warmup: int = 2) -> float:
    """Best-of-``iters`` wall time of ``fn(arg)``, each call waited for on
    the device.  The warm-up calls include NCCL's communicator set-up,
    which happens at a group's first collective."""
    for _ in range(warmup):
        fn(arg)
    _sync(arg.device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(arg)
        _sync(arg.device)
        best = min(best, time.perf_counter() - t0)
    return best


def _payload_elems(size_mb: float, itemsize: int, divisor: int) -> int:
    """The reference's element count for ``size_mb``: at least
    ``divisor``, rounded down to a multiple of it."""
    n_elems = max(divisor, int(size_mb * 1e6) // itemsize)
    return n_elems - n_elems % divisor


def _arange_block(n_elems: int, blocks: int, index: int, dtype,
                  device) -> torch.Tensor:
    """Block ``index`` of ``blocks`` equal blocks of the reference's input,
    ``arange(n_elems)`` in f32 cast to ``dtype``."""
    size = n_elems // blocks
    return torch.arange(index * size, (index + 1) * size,
                        dtype=torch.float32, device=device).to(dtype)


def collective_input(mesh, op: str, axis: str, size_mb: float,
                     dtype=torch.bfloat16):
    """(this rank's input to ``op`` over ``axis`` at ``size_mb``, the whole
    array's element count): the whole array for ``reduce_scatter``, this
    rank's block along ``axis`` for the others."""
    n = mesh.shape[axis]
    n_elems = _payload_elems(size_mb, dtype.itemsize, n)
    if op == "reduce_scatter":
        return _arange_block(n_elems, 1, 0, dtype, mesh.device), n_elems
    return (_arange_block(n_elems, n, mesh.coord[axis], dtype, mesh.device),
            n_elems)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty(dist.get_world_size(group) * x.numel())
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty(x.numel() // dist.get_world_size(group))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def _collective_fn(op: str, axis: str, mesh):
    """``op`` over ``axis``'s process group as a function of this rank's
    flat input (:func:`collective_input`)."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    group = mesh.process_group(axis)
    if op == "all_reduce":
        return lambda x: _all_reduce(x, group)
    if op == "all_gather":
        return lambda x: _all_gather(x, group)
    if op == "reduce_scatter":
        return lambda x: _reduce_scatter(x, group)
    send_to, recv_from = mesh.ring_peers(axis)
    return lambda x: ring_hop([x], group, send_to, recv_from)[0]


def run_collective(
    mesh,
    op: str = "all_reduce",
    axis: str = "data",
    size_mb: float = 64.0,
    iters: int = 10,
    dtype=torch.bfloat16,
) -> CollectiveResult:
    """Benchmark one collective at one size over one mesh axis."""
    n = mesh.shape[axis]
    fn = _collective_fn(op, axis, mesh)
    x, n_elems = collective_input(mesh, op, axis, size_mb, dtype)
    secs = _timed(fn, x, iters)
    size_bytes = n_elems * dtype.itemsize
    algbw = size_bytes / secs / 1e9
    return CollectiveResult(
        op=op,
        axis=axis,
        size_bytes=size_bytes,
        seconds=secs,
        algbw_gbps=algbw,
        busbw_gbps=algbw * _bus_factor(op, n),
    )


def sweep(
    mesh,
    axis: str = "data",
    ops: Optional[List[str]] = None,
    sizes_mb: Optional[List[float]] = None,
    iters: int = 10,
) -> List[CollectiveResult]:
    """The all-reduce sweep of BASELINE configs 2/5: sizes x ops over an
    axis; returns per-point results (peak busbw is the headline number).
    Every rank must call it with the same arguments."""
    ops = ops or list(OPS)
    sizes_mb = sizes_mb or [1.0, 8.0, 64.0, 256.0]
    out = []
    for op in ops:
        for size in sizes_mb:
            out.append(run_collective(mesh, op, axis, size, iters))
    return out


def peak_busbw(results: List[CollectiveResult]) -> float:
    return max((r.busbw_gbps for r in results), default=0.0)


# -- DCN collective strategy (operator topology-plan consumption) -------------
#
# The planner hints ring vs hierarchical for the gradient all-reduce that
# spans DCN (``mesh.dcn_collective`` reads the hint off the bootstrap's
# plan block).  Both sum every replica's contribution over the
# intra-group axis (ici) and the cross-group axis (dcn): ``ring`` is one
# all-reduce over the group spanning both; ``hierarchical`` is a
# reduce-scatter over ici, an all-reduce of the 1/k shard over dcn and an
# all-gather back over ici, so every slow cross-group hop moves 1/k of
# the payload.  The hint only picks the decomposition.


def dcn_all_reduce(x: torch.Tensor, dcn_group, ici_group=None,
                   strategy: str = "ring", *,
                   span_group=None) -> torch.Tensor:
    """The gradient-sync all-reduce of this rank's flat block, decomposed
    per the plan's strategy: ``ring`` sums over ``span_group`` (the group
    over dcn x ici) in place, ``hierarchical`` reduce-scatters over
    ``ici_group``, all-reduces over ``dcn_group`` and all-gathers over
    ``ici_group``.  Without an ``ici_group`` both are the all-reduce over
    ``dcn_group``."""
    if ici_group is None:
        return _all_reduce(x, dcn_group)
    if strategy == "hierarchical":
        x = _reduce_scatter(x, ici_group)
        x = _all_reduce(x, dcn_group)
        return _all_gather(x, ici_group)
    return _all_reduce(x, span_group)


def make_dcn_all_reduce(mesh, dcn_axis: str = "data",
                        ici_axis: str = "fsdp", strategy: str = "ring"):
    """The whole-array gradient all-reduce over ``mesh`` with the planned
    strategy, as a function of this rank's block of the array sharded
    over (dcn, ici), dcn outermost (block ``mesh.index(dcn_axis,
    ici_axis)``); each rank's result is the elementwise total of its
    block's position, so both strategies give the same global array.
    Builds the groups it needs (collectively: every rank must call it
    with the same arguments, in the same order)."""
    if strategy == "hierarchical" and mesh.shape.get(ici_axis, 1) <= 1:
        # nothing to scatter over: the decomposition degenerates to the
        # flat form -- never issue a 1-way scatter/gather pair
        strategy = "ring"
    dcn_group = mesh.process_group(dcn_axis)
    ici_group = span_group = None
    if ici_axis:
        ici_group = mesh.process_group(ici_axis)
        if strategy != "hierarchical":
            span_group = mesh.process_group(dcn_axis, ici_axis)

    def fn(x):
        return dcn_all_reduce(x, dcn_group, ici_group, strategy,
                              span_group=span_group)

    return fn


def dcn_input(mesh, size_mb: float, dcn_axis: str = "data",
              ici_axis: str = "fsdp", dtype=torch.bfloat16):
    """(this rank's block of the planned all-reduce's input at
    ``size_mb``, the whole array's element count): the reference's
    ``arange(n_elems)`` sharded over (dcn, ici), dcn outermost, so the
    block is the rank's index along those axes, whatever the mesh's axis
    order."""
    dcn = mesh.shape[dcn_axis]
    ici = mesh.shape.get(ici_axis, 1)
    n = dcn * ici
    # each rank's block splits again over ici for the hierarchical
    # reduce-scatter, and the dcn ring segments the scattered shard once
    # more: gloo's tcp pair aborts on odd-byte segments, so every level
    # stays 8-byte aligned (and NCCL's ring segments aligned)
    n_elems = _payload_elems(size_mb, dtype.itemsize, n * ici * dcn * 4)
    axes = (dcn_axis, ici_axis) if ici_axis else (dcn_axis,)
    return (_arange_block(n_elems, n, mesh.index(*axes), dtype, mesh.device),
            n_elems)


def time_dcn_all_reduce(
    mesh,
    size_mb: float,
    *,
    dcn_axis: str = "data",
    ici_axis: str = "fsdp",
    strategy: str = "ring",
    iters: int = 5,
    dtype=torch.bfloat16,
) -> CollectiveResult:
    """Wall-time the planned gradient all-reduce on a live mesh -- the
    measured half of the planner's modeled objective (exec-bench).  Every
    rank must call this with the same arguments (the collective blocks
    until all ranks join); the returned best-of time is this rank's own
    observation."""
    x, n_elems = dcn_input(mesh, size_mb, dcn_axis, ici_axis, dtype)
    fn = make_dcn_all_reduce(mesh, dcn_axis=dcn_axis, ici_axis=ici_axis,
                             strategy=strategy)
    secs = _timed(fn, x, iters)
    size_bytes = n_elems * dtype.itemsize
    algbw = size_bytes / secs / 1e9
    n = mesh.shape[dcn_axis] * mesh.shape.get(ici_axis, 1)
    return CollectiveResult(
        op=f"dcn_all_reduce[{strategy}]",
        axis=f"{dcn_axis}+{ici_axis}",
        size_bytes=size_bytes,
        seconds=secs,
        algbw_gbps=algbw,
        busbw_gbps=algbw * _bus_factor("all_reduce", n),
    )
