"""The port's ops held against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run in interpret mode on the CPU, as the JAX suite runs
them, so the port's plain versions are held to the kernels themselves.
Each tolerance is stated beside its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.ops import attention as jattn
from tpu_network_operator.ops import norms as jnorms
from tpu_network_operator.ops import pallas_attention as jpa
from tpu_network_operator.ops import rope as jrope
from tpu_network_operator_torch.ops import attention as tattn
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.ops import norms as tnorms
from tpu_network_operator_torch.ops import rope as trope

SCALING = {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
           "original_max_position_embeddings": 64}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


# -- rope ---------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [None, SCALING], ids=["plain", "llama3"])
def test_rope_angles_match(scaling):
    # f32 tables from the same f32 angles: cos/sin implementations differ
    # by an ulp or so at arguments up to ~250 rad
    jc, js = jrope.rope_angles(256, 64, 500_000.0, scaling=scaling)
    tc, ts = trope.rope_angles(256, 64, 500_000.0, scaling=scaling)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-6)


def test_llama3_scaling_changes_low_frequencies():
    # the scaled tables differ from plain ones at long wavelengths only
    _, pc = trope.rope_angles(64, 64, 500_000.0)
    _, sc = trope.rope_angles(64, 64, 500_000.0, scaling=SCALING)
    assert torch.equal(pc[:, 0], sc[:, 0])        # highest frequency kept
    assert not torch.equal(pc[:, -1], sc[:, -1])  # lowest slowed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_and_at_match(dtype):
    # f32: same products in the same order, so ~1 ulp; bf16: one output
    # rounding on each side, so at most one bf16 ulp (2^-8 relative)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = np.array([3, 7, 11, 12, 20, 21, 22, 40, 41, 42, 43, 50, 51, 60,
                    61, 62], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    atol = 1e-6 if dtype == "float32" else 2e-2
    jc, js = jrope.rope_angles(64, 64, scaling=SCALING)
    tc, ts = trope.rope_angles(64, 64, scaling=SCALING)
    ref = jrope.apply_rope(_j(x, jdt), jc, js, offset=5)
    out = trope.apply_rope(_t(x, tdt), tc, ts, offset=5)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=atol)
    ref = jrope.apply_rope_at(_j(x, jdt), jc, js, jnp.asarray(pos))
    out = trope.apply_rope_at(_t(x, tdt), tc, ts,
                              torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=atol)


# -- attention ----------------------------------------------------------------


def test_repeat_kv_matches():
    x = np.random.default_rng(1).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    for n_rep in (1, 3):
        np.testing.assert_array_equal(
            tattn.repeat_kv(_t(x), n_rep).numpy(),
            _np(jattn.repeat_kv(_j(x), n_rep)),
        )


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("q_offset,use_mask", [(0, False), (5, False),
                                               (3, True)])
def test_causal_attention_matches(n_rep, q_offset, use_mask):
    # f32 throughout: the two einsums and the softmax differ only in
    # summation order, ~1e-6
    rng = np.random.default_rng(10 * n_rep + q_offset)
    b, sq, sk, hkv, d = 2, 6, 11, 2, 16
    q = rng.standard_normal((b, sq, hkv * n_rep, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    mask = rng.random((sq, sk)) > 0.3 if use_mask else None
    if mask is not None:
        mask[:, 0] = True        # every row keeps at least one key
    ref = jattn.causal_attention(
        _j(q), _j(k), _j(v), q_offset=q_offset,
        mask=None if mask is None else jnp.asarray(mask),
    )
    out = tattn.causal_attention(
        _t(q), _t(k), _t(v), q_offset=q_offset,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-6)


def test_causal_attention_bf16_casts_match():
    # bf16: the products run in bf16 and the probabilities are cast to
    # bf16 before PV on both sides; one bf16 ulp of slack (2^-8 relative)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 9, 2, 16)).astype(np.float32)
    ref = jattn.causal_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                 _j(v, jnp.bfloat16), q_offset=5)
    out = tattn.causal_attention(_t(q, torch.bfloat16),
                                 _t(k, torch.bfloat16),
                                 _t(v, torch.bfloat16), q_offset=5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2e-2)


# -- rms norm -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_jnp_and_pallas(dtype):
    # same f32 math on all three; the mean's summation order differs, so
    # f32 agrees to ~1e-6 and bf16 to one output ulp (2^-8 relative)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 8, 256)) * 3.0).astype(np.float32)
    s = (rng.standard_normal(256) + 1.0).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-6 if dtype == "float32" else 8e-3
    out = tnorms.rms_norm(_t(x, tdt), _t(s, tdt), 1e-5)
    assert out.dtype == tdt and out.shape == x.shape
    ref_jnp = jnorms._rms_norm_jnp(_j(x, jdt), _j(s, jdt), 1e-5)
    assert jnorms.supports(32, 256)
    ref_pallas = jnorms.pallas_rms_norm(_j(x, jdt), _j(s, jdt), 1e-5)
    for ref in (ref_jnp, ref_pallas):
        np.testing.assert_allclose(out.float().numpy(), _np(ref),
                                   rtol=rtol, atol=1e-6)


def test_rms_norm_any_row_count_on_cpu():
    # the port drops the TPU row-tiling gate: 5 rows of 96 are fine
    x = torch.randn(5, 96, generator=torch.Generator().manual_seed(0))
    s = torch.ones(96)
    y = tnorms.rms_norm(x, s)
    np.testing.assert_allclose(
        y.numpy(), _np(jnorms._rms_norm_jnp(_j(x.numpy()), _j(s.numpy()),
                                            1e-5)), rtol=1e-6, atol=1e-6)


# -- flash attention ----------------------------------------------------------


def _qkv(seed, b, h, hkv, s, d, layout):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)]
    else:
        shapes = [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_chunk_fwd(seq, causal, dtype):
    # both round q*scale and p to bf16 at the same points; what is left is
    # f32 summation order and exp, which can flip one bf16 rounding of p:
    # O within 2e-3 (f32 out) or one bf16 ulp at |O| < 1 (bf16 out), LSE
    # (never rounded) within 1e-5
    q, k, v = _qkv(seq + causal, 2, 4, 2, seq, 64, "bhsd")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo, jl = jpa.chunk_fwd(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                           causal=causal, block_q=128, block_k=128)
    to, tl = tfa.chunk_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                           causal=causal, block_q=128, block_k=128)
    assert to.dtype == tdt and tl.shape == (2, 4, seq)
    atol = 2e-3 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to.float().numpy(), _np(jo), atol=atol)
    np.testing.assert_allclose(tl.numpy(), _np(jl)[..., 0], atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bshd_matches_pallas(causal):
    # public [B, S, H, D] entry; same tolerance reasoning as above (bf16)
    q, k, v = _qkv(7, 1, 4, 1, 256, 64, "bshd")
    ref = jpa.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                              _j(v, jnp.bfloat16), block_q=128,
                              block_k=128, causal=causal)
    out = tfa.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), block_q=128,
                              block_k=128, causal=causal)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=1e-2)


def test_flash_plain_matches_causal_attention():
    # the blockwise algorithm is the plain softmax up to the two bf16
    # roundings (q*scale, p): f32 inputs agree within a few bf16 ulps
    q, k, v = _qkv(9, 2, 4, 2, 256, 64, "bshd")
    out = tfa.flash_attention(_t(q), _t(k), _t(v), block_q=128, block_k=128)
    ref = tattn.causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-2)


def test_flash_block_validation_and_gate():
    q = torch.zeros(1, 192, 2, 64)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q, q, q, block_q=128, block_k=128)
    for args in [(128, 128, 64), (512, 512, 128), (1024, 1024, 64),
                 (192, 192, 64), (128, 128, 80), (64, 64, 64)]:
        assert tfa.supports(*args) == jpa.supports(*args), args
