"""The plain flash versions at the kernels' own tiles, held to the Pallas
kernels at the same blocking, on the CPU.

The CUDA kernels tile as ``FWD_TILE``, ``DQ_TILE`` and ``DKV_TILE`` of
``ops/flash_attention.py`` say, and ``chip_smoke.py`` and the card tests
hold each kernel to its plain version run at those tiles.  Here the plain
versions at those tiles are held to ``pallas_attention.chunk_fwd`` and
``_bwd_core`` (interpret mode, as the JAX suite runs them off-TPU) at the
same blocking, so the chain kernel -> plain -> Pallas holds at the blocking
the card runs.  Inputs are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_network_operator.ops import pallas_attention as jpa
from tpu_network_operator_torch.ops import flash_attention as tfa

S = 256
CASES = [(d, n_rep, causal) for d in (64, 128) for n_rep in (1, 4)
         for causal in (True, False)]


def _inputs(seed, n_rep, d):
    """q, k, v, do in [B, H, S, D] f32, one kv-head (H = n_rep)."""
    rng = np.random.default_rng(seed)
    shapes = [(1, n_rep, S, d), (1, 1, S, d), (1, 1, S, d), (1, n_rep, S, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, ref):
    a, ref = _np(a), _np(ref)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-12))


def test_tiles_are_the_kernels_blocking():
    # forward: 128-row q tiles against 128-key tiles; dQ 128-row q tiles
    # against 64-key tiles; dK/dV 128-key tiles against 64-row q steps, as
    # (q rows, keys)
    assert tfa.FWD_TILE == (128, 128)
    assert tfa.DQ_TILE == (128, 64)
    assert tfa.DKV_TILE == (64, 128)


@pytest.mark.parametrize("s,tile,block", [(256, 128, 128), (200, 128, 200),
                                          (64, 128, 128), (777, 64, 777)])
def test_plain_block_is_the_tile_or_one_ragged_block(s, tile, block):
    assert tfa._plain_block(s, tile) == block


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 200])
def test_plain_at_tiles_runs_the_kernels_blocking(s, causal):
    # the references the kernels are held to on the card: the plain
    # versions blocked at FWD_TILE, DQ_TILE and DKV_TILE where those divide
    # the sequence, else in one block; the same arithmetic, the same bits
    rng = np.random.default_rng(s + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in [(1, 2, s, 64), (1, 1, s, 64), (1, 1, s, 64),
                                (1, 2, s, 64)])
    blk = {n: tuple(tfa._plain_block(s, t) for t in tile) for n, tile in
           (("fwd", tfa.FWD_TILE), ("dq", tfa.DQ_TILE),
            ("dkv", tfa.DKV_TILE))}
    o, lse = tfa._flash_fwd_plain_at_tiles(q, k, v, causal=causal)
    ro, rlse = tfa._flash_fwd_plain(q, k, v, block_q=blk["fwd"][0],
                                    block_k=blk["fwd"][1], causal=causal)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    delta = tfa.attention_delta(o, do)
    out = tfa._flash_bwd_plain_at_tiles(q, k, v, do, lse, delta,
                                        causal=causal)
    args = (q, k, v, do, lse, delta)
    ref_dq = tfa._flash_bwd_plain(*args, block_q=blk["dq"][0],
                                  block_k=blk["dq"][1], causal=causal)[0]
    ref_dkv = tfa._flash_bwd_plain(*args, block_q=blk["dkv"][0],
                                   block_k=blk["dkv"][1], causal=causal)[1:]
    for t, r in zip(out, (ref_dq, *ref_dkv)):
        assert t.dtype == torch.float32 and torch.equal(t, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n_rep,causal", CASES)
def test_fwd_plain_at_kernel_tiles_matches_pallas(d, n_rep, causal, dtype):
    # the same blocking on both sides, so the online softmax rounds P to
    # bf16 against the same running max; what is left is exp and f32
    # summation order, which flip the bf16 rounding of a few p (measured:
    # 30 of 65,536 outputs off by up to 3.7e-5).  f32 outputs: 1e-5 in
    # relative norm and per element, but 1e-4 absolute for those flips.
    # bf16 outputs: one output rounding on each side, one bf16 ulp at
    # |O| < 1 (1e-2).  The LSE is never rounded (1e-5)
    q, k, v, _ = _inputs(100 * d + 10 * n_rep + causal, n_rep, d)
    bq, bk = tfa.FWD_TILE
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo, jl = jpa.chunk_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                           causal=causal, block_q=bq, block_k=bk)
    to, tl = tfa._flash_fwd_plain(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, k, v)),
                                  block_q=bq, block_k=bk, causal=causal)
    assert to.dtype == tdt and tl.shape == (1, n_rep, S)
    if dtype == "float32":
        np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5, atol=1e-4)
        assert _rel(to, jo) < 1e-5
    else:
        np.testing.assert_allclose(to.float().numpy(), _np(jo), atol=1e-2)
    np.testing.assert_allclose(tl.numpy(), _np(jl)[..., 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n_rep,causal", CASES)
def test_bwd_plain_at_kernel_tiles_matches_pallas(d, n_rep, causal, dtype):
    # dq, dk, dv from the same (the JAX forward's) lse and delta, at the
    # dK/dV kernel's blocking on both sides: P = exp(S - lse) is
    # elementwise, so what is left is exp and f32 summation order, which
    # can flip one bf16 rounding of an operand (p, dS): measured up to
    # 1.6e-4 on a few elements of gradients of magnitude ~1, and 3.7e-5 in
    # relative norm.  f32: 1e-5 per element, 5e-4 absolute for those
    # flips, 1e-4 in relative norm.  bf16
    # inputs (the test_torch_ops_bwd.py tolerances): 3e-2 absolute and
    # 1e-2 in relative norm
    q, k, v, do = _inputs(200 * d + 10 * n_rep + causal, n_rep, d)
    bq, bk = tfa.DKV_TILE
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = jpa.chunk_fwd(jq, jk, jv, causal=causal, block_q=bq,
                             block_k=bk)
    jdelta = jpa.attention_delta(jo, jdo)
    ref = jpa._bwd_core(jq, jk, jv, jdo, jlse, jdelta, block_q=bq,
                        block_k=bk, causal=causal)

    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    delta = torch.from_numpy(_np(jdelta)[..., 0].copy())
    out = tfa._flash_bwd_plain(tq, tk, tv, tdo, lse, delta, block_q=bq,
                               block_k=bk, causal=causal)
    for name, t, j in zip(("dq", "dk", "dv"), out, ref):
        assert t.dtype == torch.float32 and t.shape == j.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-5,
                                       atol=5e-4, err_msg=name)
            assert _rel(t, j) < 1e-4, (name, _rel(t, j))
        else:
            np.testing.assert_allclose(t.numpy(), _np(j), atol=3e-2,
                                       err_msg=name)
            assert _rel(t, j) < 1e-2, name


# the dQ kernel's blocking, as (d, sq, sk, n_rep, causal): D 64 and 128;
# S 200, ragged (one plain block of all rows, as the kernel's masked tail
# tile reduces to); Sq != Sk, the ring seam's past chunk with more keys
# than queries
DQ_CASES = [(64, 256, 256, 4, True), (128, 256, 256, 1, True),
            (64, 200, 200, 2, True), (128, 200, 200, 4, False),
            (64, 128, 384, 2, False), (128, 256, 384, 1, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,sq,sk,n_rep,causal", DQ_CASES)
def test_dq_plain_at_dq_tile_matches_pallas(d, sq, sk, n_rep, causal, dtype):
    # _flash_bwd_dq_plain blocked at DQ_TILE (what the card holds the dQ
    # kernel to) against the Pallas _dq_kernel at the same blocking, f32
    # dq as chunk_bwd gives it, from the same (the JAX forward's) lse and
    # delta.  Tolerances as in the test above, for the same reasons: f32
    # 1e-5 per element with 5e-4 absolute for a flipped bf16 rounding of p
    # or dS, 1e-4 in relative norm; bf16 inputs 3e-2 absolute and 1e-2 in
    # relative norm
    rng = np.random.default_rng(1000 * d + sq + sk + 10 * n_rep + causal)
    q, do = (rng.standard_normal((1, n_rep, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 1, sk, d)).astype(np.float32)
            for _ in range(2))
    bq, bk = (tfa._plain_block(n, t) for n, t in zip((sq, sk), tfa.DQ_TILE))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = jpa.chunk_fwd(jq, jk, jv, causal=causal, block_q=bq,
                             block_k=bk)
    jdelta = jpa.attention_delta(jo, jdo)
    ref = jpa.chunk_bwd(jq, jk, jv, jdo, jlse, jdelta, causal=causal,
                        block_q=bq, block_k=bk)[0]

    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    delta = torch.from_numpy(_np(jdelta)[..., 0].copy())
    bp = tfa._bwd_plain_at(*(torch.from_numpy(a).to(tdt)
                             for a in (q, k, v, do)), lse, delta,
                           tfa.DQ_TILE, causal)
    assert (bp.bq, bp.bk) == (bq, bk)
    dq = tfa._flash_bwd_dq_plain(bp, torch.float32)
    assert dq.dtype == torch.float32 and dq.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(dq.numpy(), _np(ref), rtol=1e-5,
                                   atol=5e-4)
        assert _rel(dq, ref) < 1e-4, _rel(dq, ref)
    else:
        np.testing.assert_allclose(dq.numpy(), _np(ref), atol=3e-2)
        assert _rel(dq, ref) < 1e-2, _rel(dq, ref)
