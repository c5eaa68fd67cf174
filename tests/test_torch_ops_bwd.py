"""The port's backward ops held against the JAX package's, on the CPU.

Inputs and cotangents are made with numpy from a seed and handed to both
packages.  The JAX side takes ``jax.vjp`` of its Pallas kernels' public
functions, which run in interpret mode on the CPU (as the JAX suite runs
them), so the port's plain backward versions are held to the TPU
kernels' own ``custom_vjp`` backward.  Each tolerance is stated beside its
reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.ops import norms as jnorms
from tpu_network_operator.ops import pallas_attention as jpa
from tpu_network_operator_torch.ops import attention as tattn
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.ops import norms as tnorms

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _rel(a, ref):
    """Relative norm of the difference."""
    a, ref = _np(a), _np(ref)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-12))


# -- RMSNorm backward ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 256), (16, 128)])
def test_rms_norm_grads_match_pallas_vjp(dtype, shape):
    # same f32 math on both sides (dx from rstd, g and mean(g * xh));
    # the row and column sums run in other orders.  f32: ~1e-6.  bf16:
    # dx is rounded once to bf16 on each side, so one bf16 ulp (2^-8
    # relative); dscale sums 32..128 rows in f32 and rounds once to bf16,
    # so again one ulp
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = JDT[dtype], TDT[dtype]
    assert jnorms.supports(int(np.prod(shape[:-1])), shape[-1])
    _, vjp = jax.vjp(lambda a, b: jnorms.pallas_rms_norm(a, b, 1e-5),
                     _j(x, jdt), _j(s, jdt))
    jdx, jds = vjp(_j(dy, jdt))

    tx, ts = _t(x, tdt, grad=True), _t(s, tdt, grad=True)
    y = tnorms.rms_norm(tx, ts, 1e-5)
    tdx, tds = torch.autograd.grad(y, (tx, ts), _t(dy, tdt))
    assert tdx.dtype == tdt and tds.dtype == tdt and tds.shape == s.shape
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(tdx.float().numpy(), _np(jdx), rtol=rtol,
                               atol=1e-5 if dtype == "float32" else 1e-2)
    np.testing.assert_allclose(tds.float().numpy(), _np(jds), rtol=rtol,
                               atol=1e-4 if dtype == "float32" else 5e-2)


def test_rms_norm_bwd_plain_matches_autograd_of_plain_forward():
    # the hand-derived backward is the gradient of the forward: f32
    # autograd through _rms_norm_plain agrees to summation order
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 96, generator=g, dtype=torch.float64).float()
    s = torch.randn(96, generator=g) + 1
    dy = torch.randn(7, 96, generator=g)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    ref = torch.autograd.grad(tnorms._rms_norm_plain(xr, sr, 1e-5),
                              (xr, sr), dy)
    rstd = tnorms._rstd_plain(x, 1e-5)
    dx, ds = tnorms._rms_norm_bwd_plain(x, s, rstd, dy)
    torch.testing.assert_close(dx, ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ds, ref[1], rtol=1e-5, atol=1e-5)


def test_rms_norm_kernel_wrappers_refuse_cpu():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.rms_norm_bwd(x, torch.ones(64), torch.ones(4), x)


# -- flash attention backward -------------------------------------------------


def _qkv(seed, b, h, hkv, s, d, layout):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)]
    else:
        shapes = [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("dtype,n_rep,causal", [
    ("float32", 1, True), ("float32", 2, False),
    ("bfloat16", 2, True), ("bfloat16", 1, False)])
def test_flash_grads_match_pallas_vjp(dtype, n_rep, causal):
    # both sides recompute P from the forward's lse and round q*scale,
    # dO, P and dS to bf16 at the same points; what is left is f32
    # summation order (forward and backward) and exp, which can flip one
    # bf16 rounding of an operand.  f32 outputs: 1e-3 absolute on
    # gradients of magnitude ~1; bf16 outputs: one output rounding on each
    # side on top, so 3e-2 absolute (one ulp at |g| in [4, 8)) and 1e-2 in
    # relative norm.  (Measured: 2e-4 in f32, 4e-3 in bf16.)
    q, k, v, do = _qkv(10 * n_rep + causal, 2, 2 * n_rep, 2, 256, 64,
                       "bshd")
    jdt, tdt = JDT[dtype], TDT[dtype]
    fn = lambda a, b, c: jpa.flash_attention(  # noqa: E731
        a, b, c, block_q=128, block_k=128, causal=causal)
    jo, vjp = jax.vjp(fn, _j(q, jdt), _j(k, jdt), _j(v, jdt))
    jgrads = vjp(_j(do, jdt))

    tq, tk, tv = (_t(a, tdt, grad=True) for a in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, block_q=128, block_k=128,
                             causal=causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(do, tdt))
    atol = 1e-3 if dtype == "float32" else 3e-2
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        assert tg.dtype == tdt and tg.shape == jg.shape, name
        np.testing.assert_allclose(tg.float().numpy(), _np(jg), atol=atol,
                                   err_msg=f"d{name}")
        assert _rel(tg.float().numpy(), jg) < 1e-2, name


def test_flash_grads_match_plain_attention_autograd():
    # the blockwise backward is the gradient of attention, up to the bf16
    # roundings of its operands: against f32 autograd through the plain
    # softmax attention, a few bf16 ulps in relative norm
    q, k, v, do = _qkv(3, 1, 4, 2, 256, 64, "bshd")
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    grads = torch.autograd.grad(
        tfa.flash_attention(tq, tk, tv, block_q=128, block_k=128),
        (tq, tk, tv), _t(do))
    rq, rk, rv = (_t(a, grad=True) for a in (q, k, v))
    refs = torch.autograd.grad(tattn.causal_attention(rq, rk, rv),
                               (rq, rk, rv), _t(do))
    for g, r in zip(grads, refs):
        assert _rel(g, r.detach()) < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_bwd_matches_pallas_chunk_bwd(causal):
    # the ring seam: f32 dq/dk/dv from given (global) lse and delta, dk/dv
    # group-summed.  Both sides take the same lse and delta (the JAX
    # forward's), so only f32 summation order and exp differ, which can
    # flip one bf16 rounding of p or dS: 2e-3 absolute
    q, k, v, do = _qkv(20 + causal, 2, 4, 2, 256, 64, "bhsd")
    bf = jnp.bfloat16
    jq, jk, jv, jdo = (_j(a, bf) for a in (q, k, v, do))
    jo, jlse = jpa.chunk_fwd(jq, jk, jv, causal=causal, block_q=128,
                             block_k=128)
    jdelta = jpa.attention_delta(jo, jdo)
    ref = jpa.chunk_bwd(jq, jk, jv, jdo, jlse, jdelta, causal=causal,
                        block_q=128, block_k=128)

    tq, tk, tv, tdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    delta = tfa.attention_delta(_t(_np(jo), torch.bfloat16), tdo)
    np.testing.assert_allclose(delta.numpy(), _np(jdelta)[..., 0],
                               rtol=1e-5, atol=1e-5)
    out = tfa.chunk_bwd(tq, tk, tv, tdo, lse, delta, causal=causal,
                        block_q=128, block_k=128)
    for name, t, j in zip(("dq", "dk", "dv"), out, ref):
        assert t.dtype == torch.float32 and t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), _np(j), atol=2e-3,
                                   err_msg=name)


def test_chunk_bwd_sums_over_chunks_to_full_gradient():
    # ring attention's contract: with the global lse and delta, the
    # diagonal chunk (causal) plus the strictly-past chunk (not causal)
    # give the full causal gradient.  Same arithmetic per element, so f32
    # summation order only
    q, k, v, do = _qkv(5, 1, 2, 1, 256, 64, "bhsd")
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = tfa.chunk_fwd(tq, tk, tv, causal=True, block_q=128,
                           block_k=128)
    delta = tfa.attention_delta(o, tdo)
    full = tfa.chunk_bwd(tq, tk, tv, tdo, lse, delta, causal=True,
                         block_q=128, block_k=128)
    h = 128                 # second half of the queries, chunked keys
    past = tfa.chunk_bwd(tq[:, :, h:], tk[:, :, :h], tv[:, :, :h],
                         tdo[:, :, h:], lse[:, :, h:], delta[:, :, h:],
                         causal=False, block_q=128, block_k=128)
    diag = tfa.chunk_bwd(tq[:, :, h:], tk[:, :, h:], tv[:, :, h:],
                         tdo[:, :, h:], lse[:, :, h:], delta[:, :, h:],
                         causal=True, block_q=128, block_k=128)
    torch.testing.assert_close(past[0] + diag[0], full[0][:, :, h:],
                               rtol=1e-5, atol=1e-5)


def test_flash_bwd_wrappers_refuse_cpu():
    q = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 128)
    for fn in (tfa._flash_bwd_dq_kernel, tfa._flash_bwd_dkv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse, causal=True, seq_dim=1, head_dim=2,
               out_f32=False)
