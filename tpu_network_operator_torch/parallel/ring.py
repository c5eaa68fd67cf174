"""Ring attention: exact causal attention over a sequence sharded on a
mesh axis.

Counterpart of ``tpu_network_operator/parallel/ring.py``.  Each rank of
the ``seq`` axis holds a contiguous chunk [B, S/n, H, D] of q, k and v, in
ring order (no zig-zag: the reference's layout).  K/V chunks travel round
the ring unrepeated (GQA is handled inside the per-chunk math), and rank i
at step j holds the chunk from rank (i - j) mod n:

* j = 0, the diagonal chunk: locally causal;
* a strictly-past chunk (source < i): attended in full;
* a future chunk (source > i): skipped.

So rank i computes i + 1 chunks, and a ring of n ranks n(n+1)/2.  The
chunk outputs are merged by their log-sum-exp.  The backward is written
by hand: with the GLOBAL lse of the merged forward and delta = rowsum(dO *
O), each chunk's gradient is exact on its own, dQ accumulates at home and
each chunk's dK/dV accumulator travels with it, home after n hops.

Two per-chunk engines:

* **flash**: the flash kernels' ring seams
  (:func:`..ops.flash_attention.chunk_fwd` / ``chunk_bwd``), kernels on
  CUDA and their plain versions on the CPU, where
  :func:`..ops.flash_attention.use_flash` takes the chunk's shape;
* **plain**: a grouped einsum softmax in f32 (the reference's
  ``_ring_kernel`` math: K never head-expanded), for shapes the route
  refuses.

The per-step body is a function of the local q, the arriving chunk, its
source index and the accumulators, and only the loop that moves chunks
talks to the process group: :func:`ring_forward_chunks` and
:func:`ring_backward_chunks` drive the same body over n chunks held in one
process (what the CPU tests and ``chip_smoke.py`` hold the group's ring
to).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import flash_attention as fa
from . import comm

NEG_INF = -1e30
IMPLS = ("auto", "flash", "plain")


# -- per-chunk engines ([B, H, S, D] layout) ----------------------------------


class _Flash:
    """The flash kernels' ring seams at the reference's blocks."""

    def __init__(self, s_local: int):
        self.blocks = dict(block_q=min(512, s_local),
                           block_k=min(512, s_local))

    def fwd(self, q, k, v, causal):
        return fa.chunk_fwd(q, k, v, causal=causal, **self.blocks)

    def bwd(self, q, k, v, do, lse, delta, causal):
        return fa.chunk_bwd(q, k, v, do, lse, delta, causal=causal,
                            **self.blocks)


class _Plain:
    """Grouped f32 softmax per chunk: q [B, H, Sq, D] in Hkv groups of
    R = H / Hkv heads against k/v [B, Hkv, Sk, D]."""

    @staticmethod
    def _scores(q, k, causal):
        b, h, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        qg = q.reshape(b, hkv, h // hkv, sq, d)
        s = torch.einsum("bhrqd,bhkd->bhrqk", qg, k).float() * d ** -0.5
        if causal:
            rows = torch.arange(sq, device=q.device)[:, None]
            s = s.masked_fill(rows < torch.arange(sk, device=q.device),
                              NEG_INF)
        return qg, s

    def fwd(self, q, k, v, causal):
        """(out [B, H, Sq, D] f32, lse [B, H, Sq] f32)."""
        b, h, sq, d = q.shape
        _, s = self._scores(q, k, causal)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        out = torch.einsum("bhrqk,bhkd->bhrqd", p, v.float())
        return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)

    def bwd(self, q, k, v, do, lse, delta, causal):
        """f32 (dq, dk, dv) of this chunk with the global lse/delta."""
        b, h, sq, d = q.shape
        hkv = k.shape[1]
        qg, s = self._scores(q, k, causal)
        shape = (b, hkv, h // hkv, sq)
        p = torch.exp(s - lse.reshape(shape)[..., None])
        dog = do.float().reshape(b, hkv, h // hkv, sq, d)
        dv = torch.einsum("bhrqk,bhrqd->bhkd", p, dog)
        dp = torch.einsum("bhrqd,bhkd->bhrqk", dog, v.float())
        ds = p * (dp - delta.reshape(shape)[..., None])
        scale = d ** -0.5
        dq = torch.einsum("bhrqk,bhkd->bhrqd", ds, k.float()) * scale
        dk = torch.einsum("bhrqk,bhrqd->bhkd", ds, qg.float()) * scale
        return dq.reshape(b, h, sq, d), dk, dv


def _engine(impl: str, s_local: int, head_dim: int):
    if impl not in IMPLS:
        raise ValueError(f"ring impl must be one of {IMPLS}, got {impl!r}")
    flash = impl == "flash" or (
        impl == "auto" and fa.use_flash(s_local, s_local, head_dim))
    return _Flash(s_local) if flash else _Plain()


# -- the per-step bodies ------------------------------------------------------


def fwd_step(engine, q, k, v, src: int, my: int, acc):
    """Rank ``my``'s forward step on the chunk from rank ``src``: ``acc``
    (None before the diagonal) is (out f32, lse), merged by LSE."""
    if src > my:
        return acc                          # a future chunk: causal skip
    out_c, lse_c = engine.fwd(q, k, v, src == my)
    if acc is None:
        return out_c.float(), lse_c
    o, lse = acc
    new = torch.logaddexp(lse, lse_c)
    return (o * torch.exp(lse - new).unsqueeze(-1)
            + out_c.float() * torch.exp(lse_c - new).unsqueeze(-1), new)


def bwd_step(engine, q, k, v, do, lse, delta, src: int, my: int, dq, dk,
             dv):
    """Rank ``my``'s backward step on the chunk from rank ``src``: (dq,
    dk, dv) with this chunk's contribution added (the diagonal starts
    them)."""
    if src > my:
        return dq, dk, dv
    dq_c, dk_c, dv_c = engine.bwd(q, k, v, do, lse, delta, src == my)
    if src == my:
        return dq_c, dk_c, dv_c
    return dq + dq_c, dk + dk_c, dv + dv_c


# -- the ring over a process group ---------------------------------------------


def _ring_fwd(engine, q, k, v, mesh, axis):
    n, my = mesh.size(axis), mesh.coord[axis]
    nxt, prv = mesh.ring_peers(axis)
    acc = None
    for j in range(n):
        acc = fwd_step(engine, q, k, v, (my - j) % n, my, acc)
        if j < n - 1:
            k, v = comm.ring_hop((k, v), mesh.group(axis), nxt, prv)
    return acc


def _ring_bwd(engine, q, k, v, do, lse, delta, mesh, axis):
    n, my = mesh.size(axis), mesh.coord[axis]
    nxt, prv = mesh.ring_peers(axis)
    dq = dk = dv = None
    for j in range(n):
        dq, dk, dv = bwd_step(engine, q, k, v, do, lse, delta, (my - j) % n,
                              my, dq, dk, dv)
        if n == 1:
            break
        # dK/dV travel with their chunk: n hops bring them home
        if j < n - 1:
            k, v, dk, dv = comm.ring_hop((k, v, dk, dv), mesh.group(axis),
                                         nxt, prv)
        else:
            dk, dv = comm.ring_hop((dk, dv), mesh.group(axis), nxt, prv)
    return dq, dk, dv


def _bhsd(t):
    return t.transpose(1, 2)


class _RingAttention(torch.autograd.Function):
    """Ring attention on this rank's [B, S/n, H, D] chunks."""

    @staticmethod
    def forward(ctx, q, k, v, engine, mesh, axis):
        o, lse = _ring_fwd(engine, _bhsd(q), _bhsd(k), _bhsd(v), mesh, axis)
        out = _bhsd(o.to(q.dtype)).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.engine, ctx.mesh, ctx.axis = engine, mesh, axis
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = fa.attention_delta(_bhsd(out), _bhsd(do))
        dq, dk, dv = _ring_bwd(ctx.engine, _bhsd(q), _bhsd(k), _bhsd(v),
                               _bhsd(do), lse, delta, ctx.mesh, ctx.axis)
        return (_bhsd(dq).to(q.dtype), _bhsd(dk).to(k.dtype),
                _bhsd(dv).to(v.dtype), None, None, None)


def _check_heads(q, k) -> None:
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({hkv})")


def ring_attention(
    q: torch.Tensor,                   # [B, S/n, H, D]: this rank's chunk
    k: torch.Tensor,                   # [B, S/n, Hkv, D]
    v: torch.Tensor,
    mesh,
    axis: str = "seq",
    impl: str = "auto",
) -> torch.Tensor:
    """Causal attention of this rank's query chunk over the whole
    sequence sharded on ``axis``, differentiable in q, k and v: the
    rank's output chunk.  ``impl``: "flash" (the kernels' seams), "plain"
    (the grouped einsum), or "auto" (flash where
    :func:`..ops.flash_attention.use_flash` takes the chunk's shape)."""
    _check_heads(q, k)
    engine = _engine(impl, q.shape[1], q.shape[-1])
    return _RingAttention.apply(q, k, v, engine, mesh, axis)


def make_ring_attn_fn(mesh, axis: str = "seq", impl: str = "auto"):
    """The model's ``attn_fn`` over ``mesh``'s ``axis`` (this rank's
    [B, S/n, H, D] chunks in, its output chunk out)."""

    def attn_fn(q, k, v):
        return ring_attention(q, k, v, mesh, axis=axis, impl=impl)

    return attn_fn


# -- the same ring over n chunks held in one process ----------------------------


def ring_forward_chunks(qs: Sequence[torch.Tensor],
                        ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], impl: str = "auto"
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring's forward over n [B, S/n, H, D] chunks in one process, in
    the group's order of steps: (outputs [B, S/n, H, D] in q's dtype, the
    global lse [B, H, S/n] f32) per rank."""
    n = len(qs)
    engine = _engine(impl, qs[0].shape[1], qs[0].shape[-1])
    acc: List[Optional[tuple]] = [None] * n
    for j in range(n):
        for my in range(n):
            src = (my - j) % n
            acc[my] = fwd_step(engine, _bhsd(qs[my]), _bhsd(ks[src]),
                               _bhsd(vs[src]), src, my, acc[my])
    outs = [_bhsd(o.to(q.dtype)).contiguous() for (o, _), q in zip(acc, qs)]
    return outs, [lse for _, lse in acc]


def ring_backward_chunks(qs, ks, vs, outs, lses, dos, impl: str = "auto"):
    """The ring's backward over n chunks in one process, each chunk's
    contributions summed in the group's order: per rank f32 (dq, dk, dv)
    in the [B, S/n, H(kv), D] layout."""
    n = len(qs)
    engine = _engine(impl, qs[0].shape[1], qs[0].shape[-1])
    deltas = [fa.attention_delta(_bhsd(o), _bhsd(d))
              for o, d in zip(outs, dos)]
    dq: List = [None] * n
    dk: List = [None] * n
    dv: List = [None] * n
    for j in range(n):
        for my in range(n):
            src = (my - j) % n
            dq[my], dk[src], dv[src] = bwd_step(
                engine, _bhsd(qs[my]), _bhsd(ks[src]), _bhsd(vs[src]),
                _bhsd(dos[my]), lses[my], deltas[my], src, my, dq[my],
                dk[src], dv[src])
    return ([_bhsd(t) for t in dq], [_bhsd(t) for t in dk],
            [_bhsd(t) for t in dv])


def _gqa_repeat_factor(h: int, hkv: int, t: int) -> int:
    """Smallest K/V head repeat that divides the GQA group and makes the
    repeated head count divisible by the ``t``-way head shard; a named
    ValueError when none exists (e.g. h=8, hkv=4 on a 3-way head axis)."""
    groups = h // hkv
    for f in range(1, groups + 1):
        if groups % f == 0 and (hkv * f) % t == 0:
            return f
    raise ValueError(
        f"no GQA repeat factor: h={h}, hkv={hkv} cannot be repeated to a "
        f"multiple of head-axis size {t}; reshard the head axis to a "
        f"divisor of hkv or disable head sharding"
    )
