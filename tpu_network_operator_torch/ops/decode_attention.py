"""Decode attention over the KV cache: a hand-written CUDA kernel and its
plain version.

A decode step's one new query row per batch row attends the filled prefix
of the layer's cache.  The kernel (``csrc/decode_attn.cu``) reads K and V
in place, through the cache buffer's strides, exactly the ``length``
filled keys, with an online softmax over streamed key tiles, so neither a
copy of the attended view nor the [B, Hkv, R, 1, len] scores reach device
memory.  It replaces no TPU kernel: the JAX package leaves this to XLA's
fusion of :func:`.attention.causal_attention`.

:func:`_decode_attention_plain` runs the same blockwise algorithm in plain
PyTorch: key tiles, f32 scores and softmax state, the probabilities
rounded to ``v``'s dtype before their product with V, as the kernel rounds
them.  :func:`decode_attention` dispatches by the tensors' device: CPU
tensors take the plain version, CUDA tensors the kernel, with no fallback
between them and no switch.

The length is a Python int or a one-element int64 tensor on the tensors'
device.  The kernel reads a tensor length from device memory when it
runs, so a CUDA graph that captured the launch once replays it at every
decode step's length; its key split is then planned for the cache's
slots, the longest length it can see.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import torch

from . import _kernels
from .flash_attention import KERNEL_HEAD_DIMS

# keys of one tile the kernel streams: the plain version's default block
DECODE_TILE = 64
# query heads of a GQA group one kernel block takes (the mma tile's rows)
KERNEL_ROWS = 16
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def _check_shapes(q, k_cache, v_cache, length) -> None:
    """The function's own conditions, on either device (a tensor length
    is checked for its form; its value is on the device)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"k_cache and v_cache must be one [B, max_len, Hkv, D] shape, got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    b, _, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(
            f"q {tuple(q.shape)} and the cache {tuple(k_cache.shape)} differ "
            "in batch or head_dim"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"decode attention takes head_dim in {KERNEL_HEAD_DIMS}, got {d}"
        )
    if h % k_cache.shape[2]:
        raise ValueError(
            f"q heads ({h}) must be a multiple of kv heads ({k_cache.shape[2]})"
        )
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int64 or length.numel() != 1 \
                or length.device != q.device:
            raise ValueError(
                f"a tensor length must be one int64 on q's device, got "
                f"{length.dtype} of {length.numel()} on {length.device}"
            )
    elif not 1 <= length <= k_cache.shape[1]:
        raise ValueError(
            f"length must be in [1, {k_cache.shape[1]}] (the cache's slots), "
            f"got {length}"
        )


def _decode_attention_plain(q, k_cache, v_cache, length: int, *,
                            block_k: int = DECODE_TILE):
    """q [B, 1, H, D]; k_cache, v_cache [B, max_len, Hkv, D] -> [B, 1, H, D]
    in q.dtype: query row 0 attends keys 0 .. length-1.  Key blocks of
    ``block_k`` (the last one ragged), online softmax with f32 state."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    scale = d ** -0.5
    qg = q[:, 0].reshape(b, hkv, h // hkv, d).float()
    m = torch.full((b, hkv, h // hkv, 1), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, h // hkv, 1), device=q.device)
    acc = torch.zeros((b, hkv, h // hkv, d), device=q.device)
    for start in range(0, length, block_k):
        stop = min(start + block_k, length)
        kj = k_cache[:, start:stop].float()
        vj = v_cache[:, start:stop].float()
        s = torch.einsum("bhrd,bkhd->bhrk", qg, kj) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = p.to(v_cache.dtype).float()
        acc = acc * alpha + torch.einsum("bhrk,bkhd->bhrd", pv, vj)
        m = m_new
    return (acc / l).to(q.dtype).reshape(b, 1, h, d)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(blocks: int, length: int, sms: int,
               head_dim: int) -> Tuple[int, int]:
    """(splits, tiles a split) of the kernel's key range, in whole
    :data:`DECODE_TILE` tiles, none empty.  A block keeps two tiles of K
    and V in flight (512 x head_dim bytes) and streams about 50 GB/s on its
    own, so about ``sms`` x 64 / head_dim blocks (66 at head_dim 128 on an
    H100) reach the card's bandwidth.  The keys split into enough parts to
    bring ``blocks`` (batch rows x kv-heads x head groups) up to that,
    where that takes three parts or more and more than 512 keys off each
    block's walk: with less, the combine step costs more than the split
    saves (measured on an H100, PERF.md)."""
    tiles = -(-length // DECODE_TILE)
    want = -(-sms * 64 // (blocks * head_dim))
    per = -(-tiles // want)
    if want < 3 or tiles - per <= 512 // DECODE_TILE:
        return 1, tiles
    return -(-tiles // per), per


def _check_kernel_inputs(q, k_cache, v_cache) -> None:
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("the decode kernel takes tensors on one CUDA device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype
            and q.dtype in _DTYPE_CODES):
        raise TypeError(
            f"the decode kernel takes bfloat16 or float16 q and cache of one "
            f"dtype, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    for t in (q, k_cache, v_cache):
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(
                "the decode kernel reads 16-byte rows: head_dim stride 1, "
                "other strides multiples of 8, 16-byte aligned data"
            )


def _decode_attention_kernel(q, k_cache, v_cache, length):
    """Launch the kernel (and, where the keys split, its combine step);
    a tensor length is read on the device, the split planned for the
    cache's slots."""
    _check_kernel_inputs(q, k_cache, v_cache)
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    blocks = b * hkv * -(-(h // hkv) // KERNEL_ROWS)
    length_dev = None
    if isinstance(length, torch.Tensor):
        length_dev, length = length.data_ptr(), k_cache.shape[1]
    splits, per = split_plan(blocks, length,
                             _sm_count(q.device.index
                                       if q.device.index is not None
                                       else torch.cuda.current_device()), d)
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    part_o = part_lse = None
    if splits > 1:
        part_o = torch.empty((splits, b, h, d), dtype=torch.float32,
                             device=q.device)
        part_lse = torch.empty((splits, b, h), dtype=torch.float32,
                               device=q.device)
    err = _kernels.lib().tpunet_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_lse is None else part_lse.data_ptr(),
        b, h, hkv, d, length, length_dev, splits, per,
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(2),
        float(d ** -0.5), _DTYPE_CODES[q.dtype],
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "decode_attn")
    _kernels.count_launch("decode_attn")
    return o


def decode_attention(
    q: torch.Tensor,                   # [B, 1, H, D]
    k_cache: torch.Tensor,             # [B, max_len, Hkv, D]
    v_cache: torch.Tensor,             # [B, max_len, Hkv, D]
    length: Union[int, torch.Tensor],
) -> torch.Tensor:
    """One decode step's attention: query row 0 of every batch row attends
    cache slots 0 .. ``length``-1 (the filled prefix, the new key
    included), read in place from the un-sliced cache.  ``length``: an int,
    or a one-element int64 tensor on q's device whose value (1 to the
    cache's slots) the kernel reads when it runs.  Returns [B, 1, H, D] in
    q's dtype.  The kernel on CUDA tensors (bfloat16 or float16), the plain
    version on CPU tensors; head_dim 64 or 128 on both."""
    _check_shapes(q, k_cache, v_cache, length)
    if q.device.type == "cuda":
        return _decode_attention_kernel(q, k_cache, v_cache, length)
    return _decode_attention_plain(q, k_cache, v_cache, int(length))
