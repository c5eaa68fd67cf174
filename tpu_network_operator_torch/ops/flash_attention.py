"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``tpu_network_operator/ops/pallas_attention.py``.  The
forward kernel (``csrc/flash_fwd.cu``) runs an online softmax over
streamed key tiles so the [S, S] score matrix never reaches device memory
and saves the f32 log-sum-exp; the backward kernels recompute the
probabilities from it, one kernel for dQ (``csrc/flash_bwd.cu``) and one
for dK/dV (``csrc/flash_bwd_dkv.cu``, which also sums each GQA group of
q-heads onto its kv-head).  Beside them,
:func:`_flash_fwd_plain` and :func:`_flash_bwd_plain` run the same
blockwise algorithms in plain PyTorch and round to bf16 where the TPU
kernels do (q * scale, dO, the probabilities and dS before their
products), so the CPU tests hold them tightly to the Pallas kernels in
interpret mode.

:func:`flash_attention` is a ``torch.autograd.Function`` (the counterpart
of the reference's ``custom_vjp`` around ``_flash_bhsd``).  Dispatch is by
the tensors' device: CPU tensors take the plain versions, CUDA tensors the
kernels, with no fallback between them and no switch.  The kernels tile
as :data:`FWD_TILE`, :data:`DQ_TILE` and :data:`DKV_TILE` say on the card,
whatever ``block_q``/``block_k`` say; those set the plain versions'
blocking and are validated on both paths (the sequence lengths must
divide by them), so the same shapes route the same way.
:func:`_flash_fwd_plain_at_tiles` and :func:`_flash_bwd_plain_at_tiles`
run the plain versions at the kernels' tiles, the references a kernel is
held to on the card.
:func:`chunk_fwd` and :func:`chunk_bwd` are the raw per-chunk seams (not
differentiable) that ring attention combines with a global lse and delta.

``window`` (0: none) narrows the causal mask to a sliding window: query i
sees key j iff ``i - window < j <= i``, the convention of transformers'
sliding masks.  The kernels and the plain versions alike skip the key
blocks wholly below the band (forward and dQ start each q block's walk at
the first block that meets it; dK/dV ends each key block's walk at the
last q block that meets it) and mask the blocks on its edges by element.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
# the kernels' tiles as (query rows, keys): the forward runs 128-row q
# tiles against 128-key tiles; dQ 128-row q tiles against 64-key tiles;
# dK/dV 128-key tiles against 64-row q steps (so its plain version's
# (block_q, block_k) is (64, 128))
FWD_TILE = (128, 128)
DQ_TILE = (128, 64)
DKV_TILE = (64, 128)


def _block_sizes(seq_q: int, seq_k: int, block_q: int,
                 block_k: int) -> Tuple[int, int]:
    bq = min(block_q, seq_q)
    bk = min(block_k, seq_k)
    if seq_q % bq or seq_k % bk:
        raise ValueError(
            f"flash attention needs seq_q ({seq_q}) divisible by block_q "
            f"({bq}) and seq_k ({seq_k}) by block_k ({bk}); pad or use "
            "ops.attention.causal_attention"
        )
    return bq, bk


def _repeat_heads(t, n_rep):
    """[B, Hkv, S, D] -> [B, Hkv * n_rep, S, D]: q-head h reads kv-head
    h // n_rep."""
    b, hkv, s, d = t.shape
    return t[:, :, None].expand(b, hkv, n_rep, s, d).reshape(b, hkv * n_rep,
                                                             s, d)


def _bf16(t):
    """t rounded to bf16 and widened back to f32 (a TPU kernel's rounding
    of a matmul operand)."""
    return t.float().to(torch.bfloat16).float()


def _check_window(window: int, causal: bool) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(
            f"a sliding window ({window}) must be >= 0 and narrows the "
            "causal mask: causal=True"
        )


def _window_masked(rows, cols, window: int):
    """Pairs below the band: row i does not see key j <= i - window."""
    return rows - cols >= window


def _first_block(i: int, bq: int, bk: int, window: int) -> int:
    """The first key block that q block ``i`` sees under ``window``."""
    return max(i * bq - window + 1, 0) // bk if window else 0


def _flash_fwd_plain(q, k, v, *, block_q: int, block_k: int, causal: bool,
                     window: int = 0):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D] -> (o [B, H, Sq, D] in
    q.dtype, lse [B, H, Sq] f32).  Blockwise online softmax, f32 state."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    n_rep = h // hkv
    bq, bk = _block_sizes(sq, sk, block_q, block_k)
    scale = d ** -0.5
    kr, vr = _repeat_heads(k, n_rep), _repeat_heads(v, n_rep)

    outs, lses = [], []
    for i in range(sq // bq):
        qi = (q[:, :, i * bq:(i + 1) * bq].float() * scale)
        qi = qi.to(torch.bfloat16).float()
        m = torch.full((b, h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for j in range(_first_block(i, bq, bk, window), sk // bk):
            if causal and j * bk > i * bq + bq - 1:
                break           # this and later key blocks are fully masked
            kj = kr[:, :, j * bk:(j + 1) * bk].float()
            vj = vr[:, :, j * bk:(j + 1) * bk].float()
            s = qi @ kj.transpose(-1, -2)
            if causal:
                rows = i * bq + torch.arange(bq, device=q.device)[:, None]
                cols = j * bk + torch.arange(bk, device=q.device)[None, :]
                s = s.masked_fill(rows < cols, NEG_INF)
                if window:
                    s = s.masked_fill(_window_masked(rows, cols, window),
                                      NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vj
            m = m_new
        outs.append((acc / l).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


class _BwdPlain:
    """Shared set-up of the two plain backward passes: q, do [B, H, Sq, D];
    k, v [B, Hkv, Sk, D]; lse, delta [B, H, Sq] f32."""

    def __init__(self, q, k, v, do, lse, delta, block_q, block_k, causal,
                 window=0):
        self.b, self.h, self.sq, self.d = q.shape
        self.hkv, self.sk = k.shape[1], k.shape[2]
        self.bq, self.bk = _block_sizes(self.sq, self.sk, block_q, block_k)
        self.scale = self.d ** -0.5
        self.causal, self.window, self.device = causal, window, q.device
        n_rep = self.h // self.hkv
        self.k = _repeat_heads(k, n_rep).float()
        self.v = _repeat_heads(v, n_rep).float()
        self.qs = _bf16(q.float() * self.scale)
        self.do = _bf16(do)
        self.lse, self.delta = lse[..., None], delta[..., None]

    def rows(self, t, i):
        return t[:, :, i * self.bq:(i + 1) * self.bq]

    def cols(self, t, j):
        return t[:, :, j * self.bk:(j + 1) * self.bk]

    def live(self, i, j):
        """Whether q block i sees some key of block j: on or below the
        diagonal, and within the window's band."""
        if self.window and j * self.bk + self.bk - 1 <= i * self.bq \
                - self.window:
            return False
        return not self.causal or j * self.bk <= i * self.bq + self.bq - 1

    def probs(self, qi, kj, i, j):
        """P = exp(S - lse) of q block i and key block j, masked."""
        s = qi @ kj.transpose(-1, -2)
        if self.causal:
            r = i * self.bq + torch.arange(self.bq, device=self.device)
            c = j * self.bk + torch.arange(self.bk, device=self.device)
            s = s.masked_fill(r[:, None] < c[None, :], NEG_INF)
            if self.window:
                s = s.masked_fill(
                    _window_masked(r[:, None], c[None, :], self.window),
                    NEG_INF)
        return torch.exp(s - self.rows(self.lse, i))


def _flash_bwd_dq_plain(bp: _BwdPlain, dq_dtype: torch.dtype):
    """The reference's ``_dq_kernel`` pass: per q block, dQ summed over
    its live key blocks, from k and v as given."""
    dqs = []
    for i in range(bp.sq // bp.bq):
        qi, doi = bp.rows(bp.qs, i), bp.rows(bp.do, i)
        acc = torch.zeros((bp.b, bp.h, bp.bq, bp.d), device=bp.device)
        for j in range(_first_block(i, bp.bq, bp.bk, bp.window),
                       bp.sk // bp.bk):
            if not bp.live(i, j):
                break
            kj = bp.cols(bp.k, j)
            p = bp.probs(qi, kj, i, j)
            ds = p * (doi @ bp.cols(bp.v, j).transpose(-1, -2)
                      - bp.rows(bp.delta, i))
            acc = acc + _bf16(ds) @ kj
        dqs.append((acc * bp.scale).to(dq_dtype))
    return torch.cat(dqs, dim=2)


def _flash_bwd_dkv_plain(bp: _BwdPlain):
    """The reference's ``_dkv_kernel`` pass: per key block, dK and dV per
    q-head summed over the live q blocks (k rounded to bf16 first, as the
    kernel rounds it), then summed over each kv-head's group in f32."""
    k16 = _bf16(bp.k)
    dks, dvs = [], []
    for j in range(bp.sk // bp.bk):
        kj, vj = bp.cols(k16, j), bp.cols(bp.v, j)
        dk = torch.zeros((bp.b, bp.h, bp.bk, bp.d), device=bp.device)
        dv = torch.zeros_like(dk)
        for i in range(bp.sq // bp.bq):
            if not bp.live(i, j):
                continue        # above the diagonal, or past the band
            qi, doi = bp.rows(bp.qs, i), bp.rows(bp.do, i)
            p = bp.probs(qi, kj, i, j)
            dv = dv + _bf16(p).transpose(-1, -2) @ doi
            ds = p * (doi @ vj.transpose(-1, -2) - bp.rows(bp.delta, i))
            dk = dk + _bf16(ds).transpose(-1, -2) @ qi
        dks.append(dk)
        dvs.append(dv)
    n_rep = bp.h // bp.hkv
    shape = (bp.b, bp.hkv, n_rep, bp.sk, bp.d)
    return (torch.cat(dks, dim=2).reshape(shape).sum(dim=2),
            torch.cat(dvs, dim=2).reshape(shape).sum(dim=2))


def _flash_bwd_plain(q, k, v, do, lse, delta, *, block_q: int,
                     block_k: int, causal: bool,
                     dq_dtype: torch.dtype = torch.float32, window: int = 0):
    """q, do: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D]; lse, delta [B, H, Sq]
    f32 -> (dq [B, H, Sq, D] in ``dq_dtype``, dk and dv [B, Hkv, Sk, D]
    f32, summed over each kv-head's group of q-heads).

    Two blockwise passes, as the reference's two kernels run them, each
    rounding its matmul operands to bf16 where that kernel does:
    :func:`_flash_bwd_dq_plain` and :func:`_flash_bwd_dkv_plain`."""
    bp = _BwdPlain(q, k, v, do, lse, delta, block_q, block_k, causal, window)
    return (_flash_bwd_dq_plain(bp, dq_dtype), *_flash_bwd_dkv_plain(bp))


def _plain_block(s: int, tile: int) -> int:
    """The plain versions' block for ``s`` rows at a kernel tile of
    ``tile``: the tile where it divides ``s``, else one block of all rows
    (a ragged tail; the plain versions need blocks that divide)."""
    return tile if s % min(tile, s) == 0 else s


def _bwd_plain_at(q, k, v, do, lse, delta, tile, causal,
                  window=0) -> _BwdPlain:
    """:class:`_BwdPlain` blocked as a kernel of tile ``tile`` (q rows,
    keys) blocks these sequences."""
    return _BwdPlain(q, k, v, do, lse, delta,
                     _plain_block(q.shape[2], tile[0]),
                     _plain_block(k.shape[2], tile[1]), causal, window)


def _flash_fwd_plain_at_tiles(q, k, v, *, causal: bool, window: int = 0):
    """:func:`_flash_fwd_plain` ([B, H, S, D]) at the forward kernel's
    tiles: what ``csrc/flash_fwd.cu`` computes, in its blocking."""
    return _flash_fwd_plain(
        q, k, v, block_q=_plain_block(q.shape[2], FWD_TILE[0]),
        block_k=_plain_block(k.shape[2], FWD_TILE[1]), causal=causal,
        window=window)


def _flash_bwd_plain_at_tiles(q, k, v, do, lse, delta, *, causal: bool,
                              dq_dtype: torch.dtype = torch.float32,
                              window: int = 0):
    """:func:`_flash_bwd_plain` ([B, H, S, D]) at the backward kernels'
    tiles: dq at :data:`DQ_TILE`, dk and dv (f32) at :data:`DKV_TILE`."""
    args = (q, k, v, do, lse, delta)
    dq = _flash_bwd_dq_plain(_bwd_plain_at(*args, DQ_TILE, causal, window),
                             dq_dtype)
    return (dq, *_flash_bwd_dkv_plain(
        _bwd_plain_at(*args, DKV_TILE, causal, window)))


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32: [B, H, S, D] -> contiguous [B, H, S]
    (the backward kernels' second statistic beside the lse).  Split out so
    the ring path can compute it once from the global output."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def _check_rows(*tensors) -> None:
    for t in tensors:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(
                "the flash kernels read 16-byte rows: head_dim stride 1, "
                "other strides multiples of 8, 16-byte aligned data"
            )


def _check_kernel_inputs(q, k, v) -> None:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("the flash kernel takes CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"the flash kernel takes bfloat16 q/k/v, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(
            f"the flash kernel takes head_dim in {KERNEL_HEAD_DIMS} and "
            f"k/v of one shape, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    _check_rows(q, k, v)


def _dims(q, k, seq_dim, head_dim):
    b, d = q.shape[0], q.shape[-1]
    sq, h = q.shape[seq_dim], q.shape[head_dim]
    sk, hkv = k.shape[seq_dim], k.shape[head_dim]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    return b, h, hkv, sq, sk, d


def _check_bwd_inputs(q, k, v, do, lse, delta, seq_dim, head_dim):
    _check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q {tuple(q.shape)} {q.dtype}, got "
            f"{tuple(do.shape)} {do.dtype}"
        )
    _check_rows(do)
    b, h, _, sq, _, _ = _dims(q, k, seq_dim, head_dim)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous [{b}, {h}, {sq}] float32, got "
                f"{tuple(t.shape)} {t.dtype}"
            )


def _strides(t, seq_dim, head_dim):
    return t.stride(0), t.stride(seq_dim), t.stride(head_dim)


def _flash_fwd_kernel(q, k, v, *, causal: bool, seq_dim: int, head_dim: int,
                      window: int = 0):
    """Launch the kernel on q/k/v whose seq and head axes are
    ``seq_dim``/``head_dim`` (1/2 for [B,S,H,D], 2/1 for [B,H,S,D]).
    Returns (o in q's layout, lse [B, H, Sq] f32)."""
    _check_kernel_inputs(q, k, v)
    b, h, hkv, sq, sk, d = _dims(q, k, seq_dim, head_dim)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)

    def strides(t):
        return _strides(t, seq_dim, head_dim)

    err = _kernels.lib().tpunet_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hkv, sq, sk, d,
        *strides(q), *strides(k), *strides(v), *strides(o),
        float(d ** -0.5), int(causal), int(window),
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_fwd")
    _kernels.count_launch("flash_fwd")
    return o, lse


def _flash_bwd_dq_kernel(q, k, v, do, lse, delta, *, causal: bool,
                         seq_dim: int, head_dim: int, out_f32: bool,
                         window: int = 0):
    """Launch the dQ kernel (layout as in :func:`_flash_fwd_kernel`):
    dq in q's layout, f32 if ``out_f32`` else bf16."""
    _check_bwd_inputs(q, k, v, do, lse, delta, seq_dim, head_dim)
    b, h, hkv, sq, sk, d = _dims(q, k, seq_dim, head_dim)
    dq = torch.empty(q.shape, device=q.device,
                     dtype=torch.float32 if out_f32 else q.dtype)
    err = _kernels.lib().tpunet_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, h, hkv, sq, sk, d,
        *(st for t in (q, k, v, do, dq)
          for st in _strides(t, seq_dim, head_dim)),
        float(d ** -0.5), int(causal), int(window), int(out_f32),
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_bwd_dq")
    _kernels.count_launch("flash_bwd_dq")
    return dq


def _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *, causal: bool,
                          seq_dim: int, head_dim: int, out_f32: bool,
                          window: int = 0):
    """Launch the dK/dV kernel: (dk, dv) in k's layout, summed over each
    kv-head's group of q-heads, f32 if ``out_f32`` else bf16."""
    _check_bwd_inputs(q, k, v, do, lse, delta, seq_dim, head_dim)
    b, h, hkv, sq, sk, d = _dims(q, k, seq_dim, head_dim)
    dtype = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, device=k.device, dtype=dtype)
    dv = torch.empty(k.shape, device=k.device, dtype=dtype)
    err = _kernels.lib().tpunet_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, hkv, sq, sk, d,
        *(st for t in (q, k, v, do, dk, dv)
          for st in _strides(t, seq_dim, head_dim)),
        float(d ** -0.5), int(causal), int(window), int(out_f32),
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_bwd_dkv")
    _kernels.count_launch("flash_bwd_dkv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention on [B, S, H, D] q and [B, S, Hkv, D] k/v, saving
    q, k, v, o and the f32 lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, window):
        if q.device.type == "cuda":
            o, lse = _flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                       head_dim=2, window=window)
        else:
            o, lse = _flash_fwd_plain(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                block_q=block_q, block_k=block_k, causal=causal,
                window=window,
            )
            o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.blocks, ctx.window = causal, (block_q, block_k), window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o.transpose(1, 2), do.transpose(1, 2))
        if q.device.type == "cuda":
            kw = dict(causal=ctx.causal, seq_dim=1, head_dim=2, out_f32=False,
                      window=ctx.window)
            dq = _flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
            dk, dv = _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
            return dq, dk, dv, None, None, None, None
        # the reference's dense backward: dq in q.dtype, dk/dv summed in
        # f32 and cast to k.dtype
        dq, dk, dv = _flash_bwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            do.transpose(1, 2), lse, delta, block_q=ctx.blocks[0],
            block_k=ctx.blocks[1], causal=ctx.causal, dq_dtype=q.dtype,
            window=ctx.window,
        )
        return (dq.transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
                dv.to(v.dtype).transpose(1, 2), None, None, None, None)


def flash_attention(
    q: torch.Tensor,                   # [B, S, H, D]
    k: torch.Tensor,                   # [B, S, Hkv, D]
    v: torch.Tensor,                   # [B, S, Hkv, D]
    *,
    block_q: int = 512,
    block_k: int = 512,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Drop-in for :func:`.attention.causal_attention` (same layout),
    differentiable in q, k and v; ``window`` > 0 sees only the last
    ``window`` keys of each query (itself included)."""
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    _check_window(window, causal)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, window)


def chunk_fwd(q, k, v, *, causal: bool,
              block_q: int = 512, block_k: int = 512):
    """One K/V chunk forward in the [B, H, S, D] layout: (out
    [B, H, Sq, D] in q.dtype, lse [B, H, Sq] f32).  ``causal=True`` for a
    diagonal chunk, ``False`` for a strictly-past one.  Not
    differentiable."""
    _block_sizes(q.shape[2], k.shape[2], block_q, block_k)
    if q.device.type == "cuda":
        return _flash_fwd_kernel(q, k, v, causal=causal, seq_dim=2,
                                 head_dim=1)
    return _flash_fwd_plain(q, k, v, block_q=block_q, block_k=block_k,
                            causal=causal)


def chunk_bwd(q, k, v, do, lse, delta, *, causal: bool,
              block_q: int = 512, block_k: int = 512):
    """One K/V chunk backward in the [B, H, S, D] layout with the GLOBAL
    lse and delta ([B, H, Sq] f32): f32 (dq [B, H, Sq, D], dk and dv
    [B, Hkv, Sk, D] summed over each kv-head's group).  Summing these over
    all chunks gives the full-attention gradient.  Not differentiable."""
    _block_sizes(q.shape[2], k.shape[2], block_q, block_k)
    if q.device.type == "cuda":
        kw = dict(causal=causal, seq_dim=2, head_dim=1, out_f32=True)
        dq = _flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
        return (dq, *_flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw))
    return _flash_bwd_plain(q, k, v, do, lse, delta, block_q=block_q,
                            block_k=block_k, causal=causal)


def supports(seq_q: int, seq_k: int, head_dim: int,
             block_q: int = 512, block_k: int = 512) -> bool:
    """Shape gate the model uses to decide flash vs plain attention (the
    reference's gate, verbatim, so the same shapes route the same way)."""
    bq = min(block_q, seq_q)
    bk = min(block_k, seq_k)
    return (
        seq_q % bq == 0
        and seq_k % bk == 0
        and bq % 128 == 0
        and bk % 128 == 0
        and head_dim % 64 == 0
    )


def use_flash(seq_q: int, seq_k: int, head_dim: int) -> bool:
    """The model's route to flash attention: the reference's shape gate
    (:func:`supports`) and a head dim the kernels are built for.  The CUDA
    kernels are compiled for D 64 and 128 only (:data:`KERNEL_HEAD_DIMS`),
    where the gate admits any multiple of 64, so D 192 or 256 takes plain
    causal attention, as the reference does wherever its gate refuses.  The
    route is the same on the CPU and the card."""
    return supports(seq_q, seq_k, head_dim) and head_dim in KERNEL_HEAD_DIMS
