"""Ulysses (all-to-all) sequence parallelism for attention.

Counterpart of ``tpu_network_operator/parallel/ulysses.py``.  Each rank of
the ``seq`` axis holds a [B, S/n, H, D] chunk; attention is parallel over
heads, so each rank trades its sequence chunk of all its heads for the
whole sequence of H/n of them, attends, and trades back:

    [B, S/n, H, D]  --all_to_all-->  [B, S, H/n, D]
    causal attention (flash where the route takes the shape)
    [B, S, H/n, D]  --all_to_all-->  [B, S/n, H, D]

Four all-to-alls per call (q, k, v and the output) against the ring's n
hops; every rank holds K/V for the whole sequence of its head group.  The
heads must divide by the ``tensor`` shards times the ``seq`` shards, and
K/V heads are repeated only up to the factor that makes them divide.
"""

from __future__ import annotations

import torch

from ..ops import flash_attention as fa
from ..ops.attention import causal_attention, repeat_kv
from . import comm


def _heads_for(axis_n: int, h: int, hkv: int) -> int:
    """Smallest K/V head repeat making the kv-head count divide the
    combined head split, capped by the full GQA expansion h/hkv."""
    rep = 1
    while (hkv * rep) % axis_n:
        rep += 1
    return min(rep, h // hkv)


def _local_attention(q, k, v):
    """Whole-sequence causal attention on the local head group: flash
    where :func:`..ops.flash_attention.use_flash` takes the shape, plain
    causal attention otherwise."""
    s, d = q.shape[1], q.shape[-1]
    if fa.use_flash(s, s, d) and q.shape[2] % k.shape[2] == 0:
        return fa.flash_attention(q, k, v)
    return causal_attention(q, k, v)


def ulysses_attention(
    q: torch.Tensor,                   # [B, S/n, H/t, D]: this rank's chunk
    k: torch.Tensor,                   # [B, S/n, Hkv/t, D]
    v: torch.Tensor,
    mesh,
    axis: str = "seq",
    head_axis: str = "tensor",
) -> torch.Tensor:
    """Causal attention of this rank's chunk over the whole sequence
    sharded on ``axis``, its heads already sharded ``head_axis``-ways;
    differentiable.  Raises a named ValueError when the heads do not
    divide by the tensor shards times the seq shards."""
    n = mesh.size(axis)
    t = mesh.size(head_axis) if head_axis else 1
    h_local, hkv_local = q.shape[2], k.shape[2]
    h = h_local * t
    if h_local % n:
        raise ValueError(
            f"ulysses needs heads {h} divisible by tensor shards {t} and "
            f"local heads {h}/{t} divisible by seq shards {n}"
        )
    # the reference's repeat over the whole head split (tensor x seq),
    # taken on this rank's heads: the same factor where kv heads divide t
    rep = _heads_for(n, h_local, hkv_local)
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    group = mesh.group(axis)
    qg, kg, vg = (comm.all_to_all(x, group, split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    out = _local_attention(qg, kg, vg)
    return comm.all_to_all(out, group, split_dim=1, concat_dim=2)


def make_ulysses_attn_fn(mesh, axis: str = "seq"):
    """The model's ``attn_fn`` (mirrors :func:`.ring.make_ring_attn_fn`)."""

    def attn_fn(q, k, v):
        return ulysses_attention(q, k, v, mesh, axis=axis)

    return attn_fn
