"""Grouped matrix products over experts: rows sorted by group, one weight
matrix a group.

No counterpart in the JAX package, whose MoE runs capacity routing's
batched einsums.  The dropless MoE route (``models/moe.py``) sorts its
token-expert assignments by expert and multiplies each expert's run of
rows by that expert's weights.  On CUDA, for bfloat16, that is one call of
PyTorch's grouped GEMM (``torch._grouped_mm``, CUTLASS on sm_90, forward
and backward); elsewhere :func:`_grouped_mm_plain`, one ``mm`` a group,
the plain version the card's product is held to.
"""

from __future__ import annotations

import torch


def _grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                      ends: torch.Tensor) -> torch.Tensor:
    """One ``mm`` a group, in x's dtype, differentiable through autograd."""
    bounds = [0] + ends.tolist()
    return torch.cat([x[a:b] @ w[g]
                      for g, (a, b) in enumerate(zip(bounds, bounds[1:]))])


def _kernel_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    return (x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16
            and hasattr(torch, "_grouped_mm"))


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """x [M, K] with group g's rows at [ends[g-1], ends[g]) (``ends`` [G]
    int32, cumulative, ends[-1] == M), w [G, K, N] -> [M, N], row r of
    group g being ``x[r] @ w[g]``."""
    if x.shape[0] != 0 and _kernel_ok(x, w):
        return torch._grouped_mm(x, w, offs=ends)
    return _grouped_mm_plain(x, w, ends)
