"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``tpu_network_operator/ops/pallas_attention.py``'s forward.
The kernel (``csrc/flash_fwd.cu``) runs an online softmax over streamed
key tiles so the [S, S] score matrix never reaches device memory.  Beside
it, :func:`_flash_fwd_plain` runs the same blockwise algorithm in plain
PyTorch and rounds to bf16 where the TPU kernel does (q * scale before
QKᵀ, the probabilities before PV), so the CPU tests hold it tightly to the
Pallas kernel in interpret mode.

Dispatch is by the tensors' device: CPU tensors take the plain version,
CUDA tensors the kernel, with no fallback between them and no switch.
The kernel tiles at 64x64 on the card whatever ``block_q``/``block_k``
say; those set the plain version's blocking and are validated on both
paths (the sequence lengths must divide by them), so the same shapes
route the same way.  The wrapper is forward-only in this slice and raises
on inputs that require grad.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


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


def _flash_fwd_plain(q, k, v, *, block_q: int, block_k: int, causal: bool):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D] -> (o [B, H, Sq, D] in
    q.dtype, lse [B, H, Sq] f32).  Blockwise online softmax, f32 state."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    n_rep = h // hkv
    bq, bk = _block_sizes(sq, sk, block_q, block_k)
    scale = d ** -0.5
    # GQA as a view: q-head h reads kv-head h // n_rep
    kr = k[:, :, None].expand(b, hkv, n_rep, sk, d).reshape(b, h, sk, d)
    vr = v[:, :, None].expand(b, hkv, n_rep, sk, d).reshape(b, h, sk, d)

    outs, lses = [], []
    for i in range(sq // bq):
        qi = (q[:, :, i * bq:(i + 1) * bq].float() * scale)
        qi = qi.to(torch.bfloat16).float()
        m = torch.full((b, h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for j in range(sk // bk):
            if causal and j * bk > i * bq + bq - 1:
                break           # this and later key blocks are fully masked
            kj = kr[:, :, j * bk:(j + 1) * bk].float()
            vj = vr[:, :, j * bk:(j + 1) * bk].float()
            s = qi @ kj.transpose(-1, -2)
            if causal:
                rows = i * bq + torch.arange(bq, device=q.device)[:, None]
                cols = j * bk + torch.arange(bk, device=q.device)[None, :]
                s = s.masked_fill(rows < cols, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vj
            m = m_new
        outs.append((acc / l).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


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
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(
                "the flash kernel reads 16-byte rows: head_dim stride 1, "
                "other strides multiples of 8, 16-byte aligned data"
            )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash kernel is forward-only: its backward is not ported"
        )


def _flash_fwd_kernel(q, k, v, *, causal: bool, seq_dim: int, head_dim: int):
    """Launch the kernel on q/k/v whose seq and head axes are
    ``seq_dim``/``head_dim`` (1/2 for [B,S,H,D], 2/1 for [B,H,S,D]).
    Returns (o in q's layout, lse [B, H, Sq] f32)."""
    _check_kernel_inputs(q, k, v)
    b, d = q.shape[0], q.shape[-1]
    sq, h = q.shape[seq_dim], q.shape[head_dim]
    sk, hkv = k.shape[seq_dim], k.shape[head_dim]
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)

    def strides(t):
        return t.stride(0), t.stride(seq_dim), t.stride(head_dim)

    err = _kernels.lib().tpunet_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hkv, sq, sk, d,
        *strides(q), *strides(k), *strides(v), *strides(o),
        float(d ** -0.5), int(causal), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_fwd")
    _kernels.count_launch("flash_fwd")
    return o, lse


def flash_attention(
    q: torch.Tensor,                   # [B, S, H, D]
    k: torch.Tensor,                   # [B, S, Hkv, D]
    v: torch.Tensor,                   # [B, S, Hkv, D]
    *,
    block_q: int = 512,
    block_k: int = 512,
    causal: bool = True,
) -> torch.Tensor:
    """Drop-in for :func:`.attention.causal_attention` (same layout)."""
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cuda":
        return _flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                 head_dim=2)[0]
    out, _ = _flash_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        block_q=block_q, block_k=block_k, causal=causal,
    )
    return out.transpose(1, 2)


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
