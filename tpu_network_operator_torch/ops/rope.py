"""Rotary position embeddings (RoPE), split-half pairing.

Counterpart of ``tpu_network_operator/ops/rope.py``.  Rotation pairs are
the split halves ``(x[:d/2], x[d/2:])`` (GPT-NeoX style), the layout the
reference keeps; a checkpoint trained with Llama's interleaved pairs loads
by permuting the wq/wk output columns once (:func:`convert_interleaved_qk`).
Hugging Face checkpoints already use the split-half layout.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch


def _llama3_scaled_freqs(
    freqs: torch.Tensor, scaling: Mapping[str, float]
) -> torch.Tensor:
    """Llama-3.1 frequency scaling (``rope_type: llama3``): long
    wavelengths slowed by ``factor``, short ones kept, and the band
    between ``low_freq_factor``/``high_freq_factor`` wavelengths of the
    original training context interpolated."""
    factor = float(scaling.get("factor", 8.0))
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / freqs
    slowed = freqs / factor
    smooth = (orig / wavelen - low) / (high - low)
    blended = (1.0 - smooth) * slowed + smooth * freqs
    return torch.where(
        wavelen > orig / low,
        slowed,
        torch.where(wavelen < orig / high, freqs, blended),
    )


def rope_angles(
    seq_len: int, head_dim: int, theta: float = 500_000.0,
    dtype: torch.dtype = torch.float32,
    scaling: Optional[Mapping[str, float]] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [seq_len, head_dim // 2] on ``device``
    (the tensors' default device when None), computed in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    freqs = 1.0 / (theta ** (exps / head_dim))
    if scaling:
        freqs = _llama3_scaled_freqs(freqs, scaling)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Split-half rotation: pair i is (x[i], x[i + d/2]); c/s broadcast
    as [seq, 1, d/2].  Math in the tables' f32, cast back to x.dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def rotate_interleaved(x: torch.Tensor, c: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation (x0, x1), (x2, x3), ... as the original
    Llama code rotates: the reference for :func:`convert_interleaved_qk`'s
    equivalence, not used on the model's path."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def deinterleave_perm(head_dim: int) -> torch.Tensor:
    """The channel permutation from interleaved pairs to split halves:
    [0, 2, 4, ..., 1, 3, 5, ...]."""
    return torch.cat([torch.arange(0, head_dim, 2),
                      torch.arange(1, head_dim, 2)])


def convert_interleaved_qk(w: torch.Tensor, head_dim: int) -> torch.Tensor:
    """A wq / wk weight [in, heads * head_dim] trained with interleaved
    pairs, its output columns permuted per head by
    :func:`deinterleave_perm` for :func:`apply_rope`'s split halves: the
    attention scores are unchanged."""
    in_dim, out = w.shape
    perm = deinterleave_perm(head_dim).to(w.device)
    return w.reshape(in_dim, out // head_dim, head_dim)[:, :, perm].reshape(
        in_dim, out)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, offset: int = 0
) -> torch.Tensor:
    """Rotate pairs.  x: [..., seq, heads, head_dim]; tables indexed at
    [offset : offset + seq]."""
    seq = x.shape[-3]
    c = cos[offset : offset + seq][:, None, :]
    s = sin[offset : offset + seq][:, None, :]
    return _rotate(x, c, s)


def apply_rope_at(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Like :func:`apply_rope` but gathering table rows at ``positions``
    [seq] (decode-time cache offsets)."""
    c = cos.index_select(0, positions)[:, None, :]
    s = sin.index_select(0, positions)[:, None, :]
    return _rotate(x, c, s)
