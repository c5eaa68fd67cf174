"""The collectives of the sharded model, as autograd Functions over one
process group.

Counterpart of the collectives inside the reference's ``shard_map``
bodies (``lax.all_gather``, ``psum``, ``ppermute``, ``all_to_all``) and of
what XLA inserts around a sharding constraint.  Each function takes the
process group of one mesh axis (or of several, flattened); ``group=None``
stands for an axis of size 1 and makes the function the identity, so the
sharded layer at a world of one runs the single-device layer's operations
and nothing else.  A group of one rank still runs its collective.

Which backward a collective needs depends on what follows it:

* :func:`split` (slice this rank's chunk of a replicated tensor) and
  :func:`gather` (all-gather; backward keeps this rank's slice) move a
  tensor between a region replicated over the axis and one sharded over
  it, where every rank of the replicated region computes the same thing;
* :func:`gather_sum` (all-gather; backward reduce-scatters) gathers a
  parameter sharded over an axis whose ranks see different data (FSDP),
  so each shard's gradient sums every rank's contribution;
* :func:`copy_to` (identity; backward all-reduces) and :func:`reduce_from`
  (all-reduce; backward identity) are Megatron's f and g around a
  column-parallel then row-parallel pair;
* :func:`psum` (all-reduce; backward all-reduces) sums statistics of the
  ranks' different rows that every rank's share of the loss then reads
  (the MoE's load-balancing loss);
* :func:`all_to_all` trades a split dim for a concatenated one (Ulysses);
* :func:`ring_hop` sends tensors to the next rank of a ring and receives
  the previous rank's (ring attention), outside autograd.

Only calls present in torch 2.11 and 2.13 are used:
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``all_to_all_single`` and ``batch_isend_irecv``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _n(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _to_front(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x with its ``dim`` cut into ``n`` chunks stacked along dim 0
    (contiguous): the layout the flat collectives read and write."""
    if dim == 0:
        return x.contiguous()
    return torch.cat(x.chunk(n, dim=dim), dim=0).contiguous()


def _from_front(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The inverse of :func:`_to_front`."""
    if dim == 0:
        return x
    return torch.cat(x.chunk(n, dim=0), dim=dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim``, in rank order (not
    differentiable)."""
    if group is None:
        return x
    n = _n(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return _from_front(out, dim, n)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tensors summed, and this rank's chunk of ``dim`` kept
    (not differentiable)."""
    if group is None:
        return x
    n = _n(group)
    flat = _to_front(x, dim, n)
    out = torch.empty((flat.shape[0] // n, *flat.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' tensors summed, into a new tensor (not differentiable)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _n(group)
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks"
        )
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def _a2a(x: torch.Tensor, group, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    n = _n(group)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"dim {split_dim} of size {x.shape[split_dim]} does not split "
            f"over {n} ranks"
        )
    # chunk i of the split dim goes to rank i: all_to_all_single splits
    # and concatenates dim 0, so the chunks are stacked there first
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, ctx.group, concat_dim, split_dim), None, None, None


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of a tensor replicated over the group;
    backward all-gathers the chunks' gradients."""
    return x if group is None else _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' chunks concatenated along ``dim`` into a tensor that the
    group then computes with alike; backward keeps this rank's slice."""
    return x if group is None else _Gather.apply(x, group, dim)


def gather_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A parameter's shards concatenated along ``dim`` for ranks that see
    different data; backward reduce-scatters (sums) the gradient, so each
    rank keeps its shard's total."""
    return x if group is None else _GatherSum.apply(x, group, dim)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity into a tensor-parallel region; backward all-reduces
    (Megatron's f)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce of the region's partial sums; backward is the identity
    (Megatron's g)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce of per-rank partial sums that each rank's share of the
    loss reads in full; backward all-reduces, since every rank's share
    depends on every rank's input."""
    return x if group is None else _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Chunk i of ``split_dim`` to rank i, the chunks received
    concatenated along ``concat_dim`` in rank order; backward is the
    reverse all-to-all."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ring_hop(tensors: Sequence[torch.Tensor], group, send_to: int,
             recv_from: int) -> List[torch.Tensor]:
    """One hop of a ring: each tensor sent to global rank ``send_to`` and
    its counterpart received from global rank ``recv_from`` (not
    differentiable; the ring's backward makes its own hops)."""
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), send_to, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, recv_from, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs

