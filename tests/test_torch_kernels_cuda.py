"""The port's CUDA kernels on the card: edge cases beyond ``chip_smoke.py``.

Every test here needs a CUDA GPU (and ``nvcc`` to build the kernels), is
marked ``cuda`` and skips without one; on a machine with the card run

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` imports the JAX package's entry
module, and the port needs no JAX.)

Each kernel is held against its plain version on the same inputs; the
tolerances are those of ``chip_smoke.py``, for the same reasons (one bf16
rounding may flip between two f32 summation orders).
"""

import dataclasses

import pytest
import torch

from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.ops import _kernels
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.ops import norms as tnorms

pytestmark = pytest.mark.cuda

RMS_TOL = {"bf16": (1e-2, 1e-2), "f16": (2e-3, 2e-3), "f32": (1e-5, 1e-5)}
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", [(1, 64), (7, 100), (3, 8192),
                                   (1000, 2048), (2, 3, 4096)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, shape):
    dt = DTYPES[dtype]
    x = (torch.randn(shape, device="cuda", generator=cuda) * 3).to(dt)
    s = (torch.randn(shape[-1], device="cuda", generator=cuda) + 1).to(dt)
    before = _kernels.LAUNCHES["rms_norm_fwd"]
    y, rstd = tnorms.fused_rms_norm(x, s, 1e-5)
    assert _kernels.LAUNCHES["rms_norm_fwd"] == before + 1
    assert y.dtype == dt and y.shape == x.shape
    assert rstd.shape == (x.numel() // shape[-1],)
    rtol, atol = RMS_TOL[dtype]
    torch.testing.assert_close(y, tnorms._rms_norm_plain(x, s, 1e-5),
                               rtol=rtol, atol=atol)
    ref = torch.rsqrt(x.float().square().mean(-1) + 1e-5).reshape(-1)
    torch.testing.assert_close(rstd, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(tnorms.rms_norm(x, s), y, rtol=0, atol=0)


def test_rms_norm_kernel_unaligned_rows(cuda):
    # a 2-byte offset takes the scalar (non-vector) load path
    buf = torch.randn(5 * 256 + 1, device="cuda", generator=cuda).bfloat16()
    x = buf[1:].view(5, 256)
    assert x.data_ptr() % 16
    s = torch.ones(256, device="cuda", dtype=torch.bfloat16)
    y, _ = tnorms.fused_rms_norm(x, s)
    torch.testing.assert_close(y, tnorms._rms_norm_plain(x, s, 1e-5),
                               rtol=1e-2, atol=1e-2)


def test_rms_norm_kernel_refuses(cuda):
    x = torch.randn(4, 8200, device="cuda")
    with pytest.raises(ValueError, match="hidden"):
        tnorms.fused_rms_norm(x, torch.ones(8200, device="cuda"))
    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tnorms.fused_rms_norm(x.t().contiguous().t(),
                              torch.ones(64, device="cuda"))
    with pytest.raises(TypeError):
        tnorms.fused_rms_norm(x, torch.ones(64, device="cuda").bfloat16())
    rstd = torch.ones(4, device="cuda")
    with pytest.raises(ValueError, match="dy"):
        tnorms.rms_norm_bwd(x, torch.ones(64, device="cuda"), rstd,
                            x.bfloat16())
    with pytest.raises(ValueError, match="rstd"):
        tnorms.rms_norm_bwd(x, torch.ones(64, device="cuda"), rstd[:3], x)


def _qkv(gen, b, sq, sk, h, hkv, d, layout="bshd"):
    if layout == "bshd":
        shapes = [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)]
    else:
        shapes = [(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]
    return [torch.randn(sh, device="cuda", generator=gen).bfloat16()
            for sh in shapes]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 128, 4, 4, 64),
                                         (2, 256, 8, 2, 64),
                                         (1, 384, 4, 1, 128),
                                         (3, 100, 4, 2, 64)])
def test_flash_kernel_matches_plain_bshd(cuda, causal, b, s, h, hkv, d):
    # s = 100: a ragged last tile (the kernel masks keys and rows past S)
    q, k, v = _qkv(cuda, b, s, s, h, hkv, d)
    before = _kernels.LAUNCHES["flash_fwd"]
    out = tfa.flash_attention(q, k, v, causal=causal, block_q=s, block_k=s)
    assert _kernels.LAUNCHES["flash_fwd"] == before + 1
    ref, _ = tfa._flash_fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), block_q=64 if s % 64 == 0
                                  else s, block_k=64 if s % 64 == 0 else s,
                                  causal=causal)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=0, atol=2e-2)


def test_flash_chunk_fwd_bhsd_and_past_chunk(cuda):
    # [B, H, S, D] layout through strides, and a strictly-past chunk with
    # more keys than queries (non-causal), LSE included
    q, k, v = _qkv(cuda, 2, 128, 256, 8, 2, 64, layout="bhsd")
    out, lse = tfa.chunk_fwd(q, k, v, causal=False, block_q=128,
                             block_k=128)
    ref, ref_lse = tfa._flash_fwd_plain(q, k, v, block_q=64, block_k=64,
                                        causal=False)
    assert lse.shape == (2, 8, 128) and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


def test_flash_kernel_refuses(cuda):
    q, k, v = _qkv(cuda, 1, 128, 128, 2, 1, 64)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    q96 = torch.zeros(1, 128, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q96, q96[:, :, :1], q96[:, :, :1])
    lse = torch.zeros(1, 2, 128, device="cuda")
    with pytest.raises(ValueError, match="do must match"):
        tfa._flash_bwd_dq_kernel(q, k, v, q.float(), lse, lse, causal=True,
                                 seq_dim=1, head_dim=2, out_f32=False)
    with pytest.raises(ValueError, match="lse"):
        tfa._flash_bwd_dkv_kernel(q, k, v, q, lse[:, :1], lse, causal=True,
                                  seq_dim=1, head_dim=2, out_f32=False)


def test_generate_on_card_matches_cpu_and_counts(cuda):
    cfg = tllama.LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                             kv_heads=2, ffn=512, max_seq=256)
    params = tllama.init_params(cfg, cuda, "cuda")
    cpu = tllama.params_to(params, "cpu")
    prompt = torch.randint(0, 512, (2, 128), device="cuda", generator=cuda)
    _kernels.reset_launches()
    out = tgen.generate(params, prompt, cfg, 6)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES == {"flash_fwd": cfg.layers,
                                 "rms_norm_fwd": (2 * cfg.layers + 1) * 6,
                                 "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                 "rms_norm_bwd": 0}
    with torch.inference_mode():
        lg = {dev: tgen.forward_with_cache(
            p, prompt.to(dev), tgen.init_cache(cfg, 2, 134, device=dev), 0,
            cfg, attn_len=128)[0].cpu()
            for dev, p in (("cuda", params), ("cpu", cpu))}
    rel = (lg["cuda"] - lg["cpu"]).abs().max() / lg["cpu"].abs().max()
    assert rel < 5e-2, rel
    assert out.shape == (2, 134)
    assert int(out.max()) < cfg.vocab_size


# -- backward kernels ---------------------------------------------------------


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", [(1, 64), (7, 100), (3, 8192),
                                   (1000, 2048), (2, 3, 4096), (5000, 96)])
def test_rms_norm_bwd_kernel_matches_plain(cuda, dtype, shape):
    # (7, 100) and (5000, 96) in bf16/f16: hidden not a multiple of the
    # 8-element vector, the scalar path; 1000 and 5000 rows: more rows
    # than the 528 row groups of the dscale reduction
    dt = DTYPES[dtype]
    x = (torch.randn(shape, device="cuda", generator=cuda) * 3).to(dt)
    s = (torch.randn(shape[-1], device="cuda", generator=cuda) + 1).to(dt)
    dy = torch.randn(shape, device="cuda", generator=cuda).to(dt)
    x2, dy2 = x.reshape(-1, shape[-1]), dy.reshape(-1, shape[-1])
    rstd = tnorms.fused_rms_norm(x, s)[1]
    before = _kernels.LAUNCHES["rms_norm_bwd"]
    dx, ds = tnorms.rms_norm_bwd(x2, s, rstd, dy2)
    assert _kernels.LAUNCHES["rms_norm_bwd"] == before + 1
    ref_dx, ref_ds = tnorms._rms_norm_bwd_plain(x2, s, rstd, dy2)
    assert dx.dtype == dt and ds.dtype == dt and ds.shape == s.shape
    rtol, atol = RMS_TOL[dtype]
    torch.testing.assert_close(dx, ref_dx, rtol=rtol, atol=atol)
    # dscale sums up to 5000 rows in another order: relative to its scale
    scale = ref_ds.float().abs().max().item()
    torch.testing.assert_close(ds.float(), ref_ds.float(), rtol=rtol,
                               atol=max(atol, 1e-4) * scale)
    # the fixed-order reduction repeats bit for bit
    again = tnorms.rms_norm_bwd(x2, s, rstd, dy2)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)


def test_rms_norm_autograd_on_card(cuda):
    x = torch.randn(4, 256, 512, device="cuda", generator=cuda).bfloat16()
    s = torch.ones(512, device="cuda", dtype=torch.bfloat16)
    x.requires_grad_()
    s.requires_grad_()
    dy = torch.randn_like(x)
    _kernels.reset_launches()
    dx, ds = torch.autograd.grad(tnorms.rms_norm(x, s), (x, s), dy)
    assert _kernels.LAUNCHES["rms_norm_fwd"] == 1
    assert _kernels.LAUNCHES["rms_norm_bwd"] == 1
    rstd = tnorms._rstd_plain(x.detach(), 1e-5)
    ref = tnorms._rms_norm_bwd_plain(x.detach().reshape(-1, 512), s.detach(),
                                     rstd, dy.reshape(-1, 512))
    torch.testing.assert_close(dx.reshape(-1, 512), ref[0], rtol=1e-2,
                               atol=1e-2)


def _flash_bwd_case(gen, b, s, h, hkv, d, causal):
    q, k, v = _qkv(gen, b, s, s, h, hkv, d)
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    o, lse = tfa._flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                   head_dim=2)
    delta = tfa.attention_delta(o.transpose(1, 2), do.transpose(1, 2))
    return q, k, v, do, lse, delta


def _assert_grad_close(out, ref, name):
    # bf16 outputs: one rounding of an operand (p, dS) may flip between
    # the two f32 summation orders; 2% of the largest gradient absolute,
    # and 1% in relative norm
    big = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(big, 1.0), (name, err, big)
    assert _rel(out, ref) < 1e-2, (name, _rel(out, ref))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 128, 4, 4, 64),
                                         (2, 256, 8, 2, 64),
                                         (1, 384, 8, 1, 128),
                                         (3, 100, 4, 2, 64),
                                         (1, 200, 8, 1, 128)])
def test_flash_bwd_kernels_match_plain(cuda, causal, b, s, h, hkv, d):
    # n_rep 1, 4 and 8; D 64 and 128; s = 100 and 200: ragged last tiles
    q, k, v, do, lse, delta = _flash_bwd_case(cuda, b, s, h, hkv, d, causal)
    kw = dict(causal=causal, seq_dim=1, head_dim=2, out_f32=False)
    before = dict(_kernels.LAUNCHES)
    dq = tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    assert _kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    blk = 64 if s % 64 == 0 else s
    rq, rk, rv = tfa._flash_bwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        do.transpose(1, 2), lse, delta, block_q=blk, block_k=blk,
        causal=causal, dq_dtype=torch.bfloat16)
    assert dq.dtype == dk.dtype == torch.bfloat16
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    _assert_grad_close(dq, rq.transpose(1, 2), "dq")
    _assert_grad_close(dk, rk.transpose(1, 2), "dk")
    _assert_grad_close(dv, rv.transpose(1, 2), "dv")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_bwd_f32_bhsd(cuda, causal):
    # the ring seam: [B, H, S, D] through strides, f32 outputs, more keys
    # than queries
    q, k, v = _qkv(cuda, 2, 128, 256, 8, 2, 64, layout="bhsd")
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    o, lse = tfa.chunk_fwd(q, k, v, causal=causal, block_q=128, block_k=128)
    delta = tfa.attention_delta(o, do)
    out = tfa.chunk_bwd(q, k, v, do, lse, delta, causal=causal,
                        block_q=128, block_k=128)
    ref = tfa._flash_bwd_plain(q, k, v, do, lse, delta, block_q=64,
                               block_k=64, causal=causal)
    for name, t, r in zip(("dq", "dk", "dv"), out, ref):
        assert t.dtype == torch.float32 and t.shape == r.shape, name
        _assert_grad_close(t, r, name)


def test_flash_autograd_on_card_counts_and_matches(cuda):
    q, k, v = _qkv(cuda, 2, 256, 256, 8, 2, 64)
    for t in (q, k, v):
        t.requires_grad_()
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    _kernels.reset_launches()
    grads = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), do)
    assert _kernels.LAUNCHES["flash_fwd"] == 1
    assert _kernels.LAUNCHES["flash_bwd_dq"] == 1
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == 1
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        tfa.flash_attention(*cpu, block_q=64, block_k=64), cpu, do.cpu())
    for name, g, r in zip("qkv", grads, ref):
        _assert_grad_close(g.cpu(), r, name)


def test_train_step_on_card_matches_cpu(cuda):
    # flash and RMSNorm kernels forward and backward under full remat,
    # chunked xent and AdamW: the loss and one step's gradients agree with
    # the CPU's plain versions to bf16 rounding order
    cfg = dataclasses.replace(
        tllama.LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=512, max_seq=256),
        remat=True, remat_policy="full", xent_chunk=64)
    params = tllama.init_params(cfg, cuda, "cuda")
    cpu = tllama.params_to(params, "cpu")
    tokens = torch.randint(0, 512, (2, 129), device="cuda", generator=cuda)
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        leaves = [t.requires_grad_() for t in
                  tllama.training.tree_leaves(p)]
        _kernels.reset_launches()
        loss = tllama.loss_fn(p, tokens.to(dev), cfg)
        out[dev] = (loss.item(), torch.autograd.grad(loss, leaves))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES == {
                "flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                "flash_bwd_dkv": cfg.layers,
                "rms_norm_fwd": 4 * cfg.layers + 1,
                "rms_norm_bwd": 2 * cfg.layers + 1}
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-2 * abs(out["cpu"][0])
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        assert _rel(g.cpu(), r) < 3e-2
