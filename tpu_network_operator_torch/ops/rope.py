"""Rotary position embeddings (RoPE), split-half pairing.

Counterpart of ``tpu_network_operator/ops/rope.py``.  Rotation pairs are
the split halves ``(x[:d/2], x[d/2:])`` (GPT-NeoX style), the layout the
reference keeps; a checkpoint trained with Llama's interleaved pairs loads
by permuting the wq/wk output columns once (:func:`convert_interleaved_qk`).
Hugging Face checkpoints already use the split-half layout.

Scalings: Llama-3.1's (a ``rope_scaling`` mapping without ``rope_type``, or
``rope_type: llama3``) and YaRN (``rope_type: yarn``, with its attention
factor on cos and sin, :func:`yarn_inv_freq`); ``rope_type: default`` is
plain RoPE.
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


def yarn_inv_freq(head_dim: int, theta: float, scaling: Mapping,
                  max_positions: Optional[int] = None,
                  device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, float]:
    """YaRN (``rope_type: yarn``) as transformers'
    ``_compute_yarn_parameters`` computes it: (inverse frequencies
    [head_dim // 2] f32, attention factor).  Each frequency blends the
    interpolated one (divided by ``factor``) into the original by a ramp
    over the dimensions whose wavelengths fit between ``beta_fast`` and
    ``beta_slow`` rotations of the original context
    (``original_max_position_embeddings``, else ``max_positions``), the
    ramp's ends truncated to whole dimensions unless ``truncate`` is false.
    The attention factor, where none is given, is ``0.1 ln(factor) + 1``
    (or the ratio of two such with ``mscale`` and ``mscale_all_dim``)."""
    factor = float(scaling["factor"])
    original = scaling.get("original_max_position_embeddings") \
        or max_positions

    def mscale(m=1.0):
        return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0

    attn = scaling.get("attention_factor")
    if attn is None:
        m, m_all = scaling.get("mscale"), scaling.get("mscale_all_dim")
        attn = mscale(m) / mscale(m_all) if m and m_all else mscale()
    fast = scaling.get("beta_fast") or 32
    slow = scaling.get("beta_slow") or 1

    def dim_of(rotations):
        return (head_dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low, high = dim_of(fast), dim_of(slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    pos = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                 device=device) / head_dim)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1 - ramp           # the share of each original frequency kept
    inv = (1.0 / (factor * pos)) * (1 - keep) + (1.0 / pos) * keep
    return inv, float(attn)


def rope_angles(
    seq_len: int, head_dim: int, theta: float = 500_000.0,
    dtype: torch.dtype = torch.float32,
    scaling: Optional[Mapping[str, float]] = None,
    device: Optional[torch.device] = None,
    max_positions: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [seq_len, head_dim // 2] on ``device``
    (the tensors' default device when None), computed in f32.
    ``scaling``: Llama-3.1's, or one with ``rope_type`` "yarn" (cos and sin
    times its attention factor; ``max_positions`` the model's context, for
    its factor) or "default" (none)."""
    kind = (scaling or {}).get("rope_type", "llama3")
    gain = 1.0
    if scaling and kind == "yarn":
        freqs, gain = yarn_inv_freq(head_dim, theta, scaling, max_positions,
                                    device)
    else:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device)
        freqs = 1.0 / (theta ** (exps / head_dim))
        if scaling and kind == "llama3":
            freqs = _llama3_scaled_freqs(freqs, scaling)
        elif scaling and kind != "default":
            raise ValueError(f"unsupported rope_type {kind!r}")
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return ((torch.cos(angles) * gain).to(dtype),
            (torch.sin(angles) * gain).to(dtype))


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
