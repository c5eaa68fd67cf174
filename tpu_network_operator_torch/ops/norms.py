"""RMSNorm: hand-written CUDA kernels (forward and backward) and their
plain versions.

Counterpart of ``tpu_network_operator/ops/norms.py``.  :func:`rms_norm`
is the one entry point the models use.  It is a ``torch.autograd.Function``
(the counterpart of the reference's ``custom_vjp`` around ``_rms_flat``)
whose forward saves the per-row f32 ``rstd`` and whose backward computes
dx and dscale from it, and each half dispatches by the tensor's device:

* a CPU tensor takes the plain versions, :func:`_rms_norm_plain` (the
  reference's ``_rms_norm_jnp``: accumulate in f32, cast back) and
  :func:`_rms_norm_bwd_plain` (``_bwd_kernel``'s f32 math);
* a CUDA tensor takes the kernels, ``csrc/rms_norm_fwd.cu`` through
  :func:`fused_rms_norm` and ``csrc/rms_norm_bwd.cu`` through
  :func:`rms_norm_bwd`.

There is no fallback from a kernel to its plain version on CUDA and no
switch that selects one: a shape or dtype the kernels do not take raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

MAX_HIDDEN = 8192
# row groups of the backward's dscale reduction: a fixed count (not the
# card's SM count), so the summation order depends on the shape alone
BWD_PARTS = 528
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rms_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, eps: float
) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def _rstd_plain(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-row f32 rstd [rows], what the forward kernel saves."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    return torch.rsqrt(x2.square().mean(dim=-1) + eps)


def _rms_norm_bwd_plain(
    x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
    dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dy [rows, hidden]; rstd [rows] f32 -> (dx in x.dtype, dscale in
    scale.dtype), with the f32 math of the reference's ``_bwd_kernel``."""
    x32 = x.float()
    dy32 = dy.float()
    r = rstd[:, None]
    xh = x32 * r
    g = dy32 * scale.float()
    mean_gxh = (g * xh).mean(dim=-1, keepdim=True)
    dx = (r * (g - xh * mean_gxh)).to(x.dtype)
    return dx, (dy32 * xh).sum(dim=0).to(scale.dtype)


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


def fused_rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (y of x's shape and dtype, rstd [rows] f32)."""
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


def rms_norm_bwd(
    x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
    dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: x, dy [rows, hidden] and the forward's rstd
    [rows] f32 -> (dx like x, dscale like scale)."""
    _check_kernel_inputs(x, scale)
    rows, h = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(
            f"dy must be contiguous and match x {tuple(x.shape)} {x.dtype}, "
            f"got {tuple(dy.shape)} {dy.dtype}"
        )
    if rstd.shape != (rows,) or rstd.dtype != torch.float32 \
            or rstd.device != x.device or not rstd.is_contiguous():
        raise ValueError(f"rstd must be contiguous [{rows}] float32")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    parts = min(rows, BWD_PARTS)
    partial = torch.empty(parts * h, dtype=torch.float32, device=x.device)
    err = _kernels.lib().tpunet_rms_norm_bwd(
        x.data_ptr(), scale.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(), rows, h, parts,
        _DTYPE_CODES[x.dtype], _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "rms_norm_bwd")
    _kernels.count_launch("rms_norm_bwd")
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """y = RMSNorm(x) * scale over the last dim, saving the f32 rstd."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        if x.device.type == "cuda":
            y, rstd = fused_rms_norm(x, scale, eps)
        else:
            y, rstd = _rms_norm_plain(x, scale, eps), _rstd_plain(x, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        h = x.shape[-1]
        x2 = x.reshape(-1, h)
        dy2 = dy.reshape(-1, h).contiguous()
        if x.device.type == "cuda":
            dx, dscale = rms_norm_bwd(x2, scale, rstd, dy2)
        else:
            dx, dscale = _rms_norm_bwd_plain(x2, scale, rstd, dy2)
        return dx.reshape(x.shape), dscale, None


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm (Llama-style, no bias) over the last dim, differentiable in
    x and scale: the kernels for a CUDA tensor, the plain versions for a
    CPU tensor."""
    return _RMSNorm.apply(x, scale, eps)
