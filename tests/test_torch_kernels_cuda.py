"""The port's CUDA kernels on the card: edge cases beyond ``chip_smoke.py``.

Every test here needs a CUDA GPU (and ``nvcc`` to build the kernels) and
skips without one; on a machine with the card run

    python -m pytest tests/test_torch_kernels_cuda.py -q

Each kernel is held against its plain version on the same inputs; the
tolerances are those of ``chip_smoke.py``, for the same reasons (one bf16
rounding may flip between two f32 summation orders).
"""

import pytest
import torch

from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.ops import _kernels
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.ops import norms as tnorms

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
    with pytest.raises(RuntimeError, match="forward-only"):
        tnorms.fused_rms_norm(x.requires_grad_(),
                              torch.ones(64, device="cuda"))


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
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.flash_attention(q.requires_grad_(), k, v)


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
                                 "rms_norm_fwd": (2 * cfg.layers + 1) * 6}
    with torch.inference_mode():
        lg = {dev: tgen.forward_with_cache(
            p, prompt.to(dev), tgen.init_cache(cfg, 2, 134, device=dev), 0,
            cfg, attn_len=128)[0].cpu()
            for dev, p in (("cuda", params), ("cpu", cpu))}
    rel = (lg["cuda"] - lg["cpu"]).abs().max() / lg["cpu"].abs().max()
    assert rel < 5e-2, rel
    assert out.shape == (2, 134)
    assert int(out.max()) < cfg.vocab_size
