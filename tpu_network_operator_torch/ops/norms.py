"""RMSNorm: a hand-written CUDA kernel and its plain version.

Counterpart of ``tpu_network_operator/ops/norms.py``.  :func:`rms_norm`
is the one entry point the models use, and it dispatches by the tensor's
device: a CPU tensor takes :func:`_rms_norm_plain` (the reference's
``_rms_norm_jnp``: accumulate in f32, cast back), a CUDA tensor takes the
kernel ``csrc/rms_norm_fwd.cu`` through :func:`fused_rms_norm`.  There is
no fallback from the kernel to the plain version on CUDA and no switch
that selects one: a shape or dtype the kernel does not take raises.

The kernel wrapper is forward-only in this slice: it raises on an input
that requires grad rather than return a result without a gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

MAX_HIDDEN = 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rms_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, eps: float
) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def _check_kernel_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("the RMSNorm kernel takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES or scale.dtype != x.dtype:
        raise TypeError(
            f"the RMSNorm kernel takes float32/bfloat16/float16 x with a "
            f"scale of the same dtype, got {x.dtype} and {scale.dtype}"
        )
    h = x.shape[-1]
    if not 0 < h <= MAX_HIDDEN or scale.shape != (h,):
        raise ValueError(
            f"hidden must be in (0, {MAX_HIDDEN}] with scale [hidden], got "
            f"x {tuple(x.shape)} and scale {tuple(scale.shape)}"
        )
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the RMSNorm kernel takes contiguous x and scale")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError(
            "the RMSNorm kernel is forward-only: its backward is not ported"
        )


def fused_rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (y of x's shape and dtype, rstd [rows] f32)."""
    _check_kernel_inputs(x, scale)
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, rstd
    err = _kernels.lib().tpunet_rms_norm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rstd.data_ptr(),
        rows, h, float(eps), _DTYPE_CODES[x.dtype],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "rms_norm_fwd")
    _kernels.count_launch("rms_norm_fwd")
    return y, rstd


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm (Llama-style, no bias) over the last dim: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return fused_rms_norm(x, scale, eps)[0]
    return _rms_norm_plain(x, scale, eps)
