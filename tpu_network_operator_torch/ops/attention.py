"""Plain attention: softmax(Q Kᵀ) V with a causal mask, GQA-aware.

Counterpart of ``tpu_network_operator/ops/attention.py`` (which XLA fuses
on the TPU; it is not a kernel there, and stays plain PyTorch here).  The
serving path uses it for the steps no kernel takes: an int8 cache, a head
dim the kernels are not built for, and several new tokens past position
0.  Prefill goes through the flash kernel (:mod:`.flash_attention`) when
its shape gate passes, and a decode step over a native cache through the
decode kernel (:mod:`.decode_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand kv heads to match query heads.
    [B, S, kvH, D] -> [B, S, kvH * n_rep, D]."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d
    )


def causal_attention(
    q: torch.Tensor,                   # [B, Sq, H, D]
    k: torch.Tensor,                   # [B, Sk, Hkv, D]
    v: torch.Tensor,                   # [B, Sk, Hkv, D]
    *,
    q_offset: int = 0,
    mask: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal (optionally masked) attention with an f32 softmax.

    Query i attends keys ``<= q_offset + i`` (and, with ``window`` > 0,
    above ``q_offset + i - window``).  GQA through a grouped
    einsum, not :func:`repeat_kv`: expanding the heads would multiply the
    K/V bytes read by n_rep, every decode step.  The score product runs in
    the input dtype and is then widened to f32, and the probabilities are
    cast to ``v.dtype`` before the PV product, as in the reference."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)

    scale = d ** -0.5
    # [B, Hkv, R, Sq, Sk]
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale

    sk = k.shape[1]
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(sk, device=q.device)[None, :]
    allowed = rows >= cols
    if window:
        allowed = allowed & (rows - cols < window)
    if mask is not None:
        allowed = allowed & mask
    logits = logits.masked_fill(~allowed, NEG_INF)

    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)
