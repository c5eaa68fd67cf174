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
import math

import pytest
import torch

from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.models import moe as tmoe
from tpu_network_operator_torch import tracing
from tpu_network_operator_torch.models import optim8bit as topt
from tpu_network_operator_torch.models import training as ttrain
from tpu_network_operator_torch.ops import _kernels
from tpu_network_operator_torch.ops import decode_attention as tda
from tpu_network_operator_torch.ops import flash_attention as tfa
from tpu_network_operator_torch.ops import norms as tnorms

pytestmark = pytest.mark.cuda

RMS_TOL = {"bf16": (1e-2, 1e-2), "f16": (2e-3, 2e-3), "f32": (1e-5, 1e-5)}
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# decode attention against its plain version, in relative norm: a bf16
# rounding of the output, with room for the f32 order
DECODE_REL = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", [(1, 64), (7, 100), (3, 8192),
                                   (1000, 2048), (2, 3, 4096),
                                   (12288, 2048), (8192, 2048),
                                   (4099, 8192), (4099, 2048)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, shape):
    # the train and prefill shapes; hidden 8192, whose rows outrun a
    # lane's registers and stream the rest; up to 1000 rows, whose blocks
    # of eight warps all fit on the card at once: eight warps a row; 4099
    # rows and more: a warp a row, walking several with the next one's
    # loads in flight
    dt = DTYPES[dtype]
    x = (torch.randn(shape, device="cuda", generator=cuda) * 3).to(dt)
    s = (torch.randn(shape[-1], device="cuda", generator=cuda) + 1).to(dt)
    before = _kernels.LAUNCHES["rms_norm_fwd"]
    y, rstd = tnorms.fused_rms_norm(x, s, 1e-5)
    assert _kernels.LAUNCHES["rms_norm_fwd"] == before + 1
    # fixed summation orders, no atomics: a repeat gives the same bits
    again = tnorms.fused_rms_norm(x, s, 1e-5)
    assert torch.equal(_bits(again[0]), _bits(y))
    assert torch.equal(_bits(again[1]), _bits(rstd))
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
    ref, _ = tfa._flash_fwd_plain_at_tiles(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=0, atol=2e-2)


def test_flash_chunk_fwd_bhsd_and_past_chunk(cuda):
    # [B, H, S, D] layout through strides, and a strictly-past chunk with
    # more keys than queries (non-causal), LSE included
    q, k, v = _qkv(cuda, 2, 128, 256, 8, 2, 64, layout="bhsd")
    out, lse = tfa.chunk_fwd(q, k, v, causal=False, block_q=128,
                             block_k=128)
    ref, ref_lse = tfa._flash_fwd_plain_at_tiles(q, k, v, causal=False)
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
                                 "rms_norm_bwd": 0, "adam8_fused": 0,
                                 "decode_attn": cfg.layers * 5,
                                 "adamw_fused": 0}
    with torch.inference_mode():
        lg = {dev: tgen.forward_with_cache(
            p, prompt.to(dev), tgen.init_cache(cfg, 2, 134, device=dev), 0,
            cfg, attn_len=128)[0].cpu()
            for dev, p in (("cuda", params), ("cpu", cpu))}
    rel = (lg["cuda"] - lg["cpu"]).abs().max() / lg["cpu"].abs().max()
    assert rel < 5e-2, rel
    assert out.shape == (2, 134)
    assert int(out.max()) < cfg.vocab_size


def _traced_launches(prof) -> dict:
    """The decode-attention and RMSNorm-forward kernels the card ran in a
    profile, counted by name (a graph replay's kernels keep theirs)."""
    from torch.autograd import DeviceType

    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {k: sum(f"{k}_kernel" in n for n in names)
            for k in ("decode_attn", "rms_norm_fwd")}


@pytest.mark.parametrize("heads,kv_heads,hidden,prompt_len,new,block", [
    (4, 2, 256, 128, 6, 256),     # the config above: D 64, flash prefill
    (4, 2, 256, 60, 12, 64),      # the eager loop crosses decode_block 64
    (32, 8, 4096, 60, 12, 64),    # GQA at D 128, H 32/8
])
def test_generate_graph_route_gives_the_eager_tokens(
        cuda, monkeypatch, heads, kv_heads, hidden, prompt_len, new, block):
    from torch.profiler import ProfilerActivity, profile

    from tpu_network_operator_torch import tracing

    cfg = tllama.LlamaConfig(vocab_size=512, hidden=hidden, layers=2,
                             heads=heads, kv_heads=kv_heads, ffn=512,
                             max_seq=256)
    params = tllama.init_params(cfg, cuda, "cuda")
    prompt = torch.randint(0, 512, (2, prompt_len), device="cuda",
                           generator=cuda)
    got = {}
    for route in ("graph", "eager"):
        if route == "eager":
            monkeypatch.setattr(tgen, "_graph_ok", lambda *a: False)
        _kernels.reset_launches()
        tracing.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = tgen.generate(params, prompt, cfg, new,
                                decode_block=block)
            torch.cuda.synchronize()
        got[route] = (out, dict(_kernels.LAUNCHES), tracing.counters(),
                      _traced_launches(prof))
        tracing.reset_counters()
    assert torch.equal(got["graph"][0], got["eager"][0])
    assert got["graph"][1] == got["eager"][1]
    assert got["graph"][1]["decode_attn"] == cfg.layers * (new - 1)
    # the counts the card ran, by kernel name in the trace
    for route in got:
        assert got[route][3] == {k: got[route][1][k]
                                 for k in ("decode_attn", "rms_norm_fwd")}
    assert got["graph"][2] == {"generate.eager_steps": 1,
                               "generate.graph_steps": new - 2}
    assert got["eager"][2] == {"generate.eager_steps": new - 1,
                               "generate.graph_steps": 0}


# -- decode attention ---------------------------------------------------------


def _decode_case(gen, b, h, hkv, d, max_len, dtype=torch.bfloat16):
    """q [B, 1, H, D] and layer 1 of a two-layer [L, B, max_len, Hkv, D]
    cache pair (the layout ``generate`` hands the kernel)."""
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(2, b, max_len, hkv, d, device="cuda",
                        generator=gen).to(dtype) for _ in range(2))
    return q, k[1], v[1]


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("b,h,hkv,d,length,split", [
    # enough blocks: one part; lengths on and off the 64-key tile
    (40, 32, 8, 128, 640, False), (40, 32, 8, 128, 767, False),
    (40, 32, 8, 128, 1, False), (72, 32, 8, 64, 385, False),
    (300, 4, 1, 128, 65, False), (2, 32, 8, 128, 64, False),
    # few blocks: the key range splits and a second kernel combines
    (2, 32, 8, 128, 767, True), (2, 32, 8, 128, 2048, True),
    (2, 16, 8, 64, 1000, True), (1, 8, 8, 128, 4097, True),
    # R 16 and R 32 (two groups of 16 query heads a kv-head), R 1
    (4, 32, 2, 128, 300, False), (3, 32, 1, 64, 129, False),
    (8, 8, 8, 64, 200, False), (1, 32, 1, 128, 3000, True),
])
def test_decode_attn_kernel_matches_plain(cuda, dtype, b, h, hkv, d, length,
                                          split):
    blocks = b * hkv * -(-(h // hkv) // tda.KERNEL_ROWS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (tda.split_plan(blocks, length, sms, d)[0] > 1) == split
    dt = DTYPES[dtype]
    q, k, v = _decode_case(cuda, b, h, hkv, d, 4200 if length > 800 else 800,
                           dt)
    before = _kernels.LAUNCHES["decode_attn"]
    out = tda.decode_attention(q, k, v, length)
    assert _kernels.LAUNCHES["decode_attn"] == before + 1
    # the plain version at the kernel's tile: f32 sums in other orders and
    # exp2 against exp can flip one rounding of p or of o
    ref = tda._decode_attention_plain(q, k, v, length,
                                      block_k=tda.DECODE_TILE)
    assert out.shape == q.shape and out.dtype == dt
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=2e-2 if dtype == "bf16" else 4e-3)
    # keys past length are never read: NaN there changes nothing
    k[:, length:] = float("nan")
    v[:, length:] = float("nan")
    assert torch.equal(tda.decode_attention(q, k, v, length), out)


@pytest.mark.parametrize("length", [1, 63, 64, 65, 800])
def test_decode_attn_device_length_matches_by_value(cuda, length):
    # 40 rows x 8 kv-heads: one part at every length, so the same bits
    q, k, v = _decode_case(cuda, 40, 32, 8, 128, 800)
    want = tda.decode_attention(q, k, v, length)
    got = tda.decode_attention(
        q, k, v, torch.full((1,), length, dtype=torch.int64, device="cuda"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_attn_split_for_the_cache_at_shorter_lengths(cuda, dtype):
    # B4 H32/8 D128 over a 2048-slot cache: a device length plans 3 parts
    # of 11 tiles for the 2048 slots; at 1 and 100 keys the last two are
    # empty, at 705 the second holds one key.  One captured launch replays
    # every length, as a decode step's graph does.  An empty part whose
    # lse were 0 in place of -inf would weigh in the combine and scale
    # the output down by a share or more, over the relative bound.
    b, h, hkv, d, slots = 4, 32, 8, 128, 2048
    blocks = b * hkv * -(-(h // hkv) // tda.KERNEL_ROWS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tda.split_plan(blocks, slots, sms, d)[0] > 1
    q, k, v = _decode_case(cuda, b, h, hkv, d, slots, dtype)
    length = torch.full((1,), slots, dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tda.decode_attention(q, k, v, length)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = tda.decode_attention(q, k, v, length)
    torch.cuda.current_stream().wait_stream(side)
    for n in (1, 100, 704, 705, 1500, slots):
        length.fill_(n)
        graph.replay()
        ref = tda._decode_attention_plain(q, k, v, n, block_k=tda.DECODE_TILE)
        rel = ((out.float() - ref.float()).norm()
               / ref.float().norm()).item()
        assert rel <= DECODE_REL, (n, rel)
        # eager, the same split: the same bits
        assert torch.equal(tda.decode_attention(q, k, v, length), out)
    # keys past the length are never read, in the empty parts neither
    length.fill_(100)
    graph.replay()
    first = out.clone()
    k[:, 100:] = float("nan")
    v[:, 100:] = float("nan")
    graph.replay()
    assert torch.equal(out, first)


def test_decode_attn_kernel_refuses(cuda):
    q, k, v = _decode_case(cuda, 2, 8, 2, 64, 32)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        tda.decode_attention(q.float(), k.float(), v.float(), 3)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        tda.decode_attention(q, k.half(), v.half(), 3)
    with pytest.raises(ValueError, match="head_dim in"):
        tda.decode_attention(q[..., :48], k[..., :48], v[..., :48], 3)
    # head_dim not the unit stride; q 2 bytes off a 16-byte boundary
    strided = k.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="16-byte rows"):
        tda.decode_attention(q, strided, v, 3)
    shifted = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)
    with pytest.raises(ValueError, match="16-byte rows"):
        tda.decode_attention(shifted[1:].view(q.shape), k, v, 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        tda.decode_attention(q, k.cpu(), v, 3)
    with pytest.raises(ValueError, match="length must be in"):
        tda.decode_attention(q, k, v, 33)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tda.decode_attention(q[:, :, :3], k, v, 3)


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
    rq, rk, rv = tfa._flash_bwd_plain_at_tiles(
        *(t.transpose(1, 2) for t in (q, k, v, do)), lse, delta,
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
    ref = tfa._flash_bwd_plain_at_tiles(q, k, v, do, lse, delta,
                                        causal=causal)
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
        tfa.flash_attention(*cpu, block_q=tfa.FWD_TILE[0],
                            block_k=tfa.FWD_TILE[1]), cpu, do.cpu())
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
                "rms_norm_bwd": 2 * cfg.layers + 1, "adam8_fused": 0,
                "decode_attn": 0, "adamw_fused": 0}
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-2 * abs(out["cpu"][0])
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        assert _rel(g.cpu(), r) < 3e-2


def _ffn_half_nodes(loss):
    """The backward nodes of the dense layers' FFN halves in ``loss``'s
    graph (``training._SwiGLUResidual``)."""
    seen, stack, out = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_SwiGLUResidualBackward":
            out.append(node)
        stack.extend(n for n, _ in node.next_functions)
    return out


def test_ffn_offload_on_card_is_ffn_bits_from_pinned_memory(cuda):
    # "ffn_offload" keeps "ffn"'s save set (resid_mid, ffn_gate, ffn_up)
    # in pinned host memory and moves it back for the backward: the bytes
    # are unchanged, so the loss and every gradient are "ffn"'s bits
    cfg = dataclasses.replace(
        tllama.LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=512, max_seq=256),
        remat=True, xent_chunk=64)
    params = tllama.init_params(cfg, cuda, "cuda")
    tokens = torch.randint(0, 512, (2, 129), device="cuda", generator=cuda)
    leaves = [t.requires_grad_() for t in tllama.training.tree_leaves(params)]
    out = {}
    for policy in ("ffn", "ffn_offload"):
        loss = tllama.loss_fn(params, tokens,
                              dataclasses.replace(cfg, remat_policy=policy))
        nodes = _ffn_half_nodes(loss)
        assert len(nodes) == cfg.layers
        for node in nodes:
            if policy == "ffn":
                assert node.stash is None
                continue
            host = node.stash.host[node.key]
            assert [tuple(h.shape) for h in host] == [
                (2, 128, cfg.hidden), (2, 128, cfg.ffn), (2, 128, cfg.ffn)]
            assert all(h.device.type == "cpu" and h.is_pinned()
                       for h in host)
            # on the device it keeps only its weights (ln and the three
            # projections)
            assert len(node.saved_tensors) == 4
            assert all(t.dim() <= 2 for t in node.saved_tensors)
        out[policy] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    assert torch.equal(_bits(out["ffn"][0]), _bits(out["ffn_offload"][0]))
    for g, r in zip(out["ffn_offload"][1], out["ffn"][1]):
        assert torch.equal(_bits(g), _bits(r))


# -- the Hopper flash kernels: edge cases --------------------------------------


def _to_bhsd(layout):
    """[B,S,H,D] <-> [B,H,S,D] for ``layout`` "bshd", else the identity."""
    return (lambda x: x.transpose(1, 2)) if layout == "bshd" else (
        lambda x: x)


def _fwd_plain(q, k, v, causal, layout):
    """The plain forward at the kernel's tiles, in the kernel's layout."""
    t = _to_bhsd(layout)
    o, lse = tfa._flash_fwd_plain_at_tiles(t(q), t(k), t(v), causal=causal)
    return t(o), lse


def _fwd_kernel(q, k, v, causal, layout):
    dims = dict(seq_dim=1, head_dim=2) if layout == "bshd" else dict(
        seq_dim=2, head_dim=1)
    return tfa._flash_fwd_kernel(q, k, v, causal=causal, **dims)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,layout", [
    (2, 200, 200, 8, 2, 64, True, "bshd"),      # ragged rows and keys
    (1, 777, 777, 4, 1, 64, True, "bshd"),
    (1, 777, 777, 8, 2, 128, False, "bshd"),
    (2, 200, 200, 4, 4, 128, True, "bshd"),
    (2, 192, 320, 8, 2, 64, False, "bhsd"),     # the past chunk: Sq != Sk
    (1, 256, 512, 4, 1, 128, False, "bhsd"),
    (2, 512, 512, 16, 4, 128, True, "bshd"),    # D 128, n_rep 4 and 1
    (1, 384, 384, 8, 8, 128, False, "bshd"),
])
def test_flash_fwd_kernel_edges(cuda, b, sq, sk, h, hkv, d, causal, layout):
    q, k, v = _qkv(cuda, b, sq, sk, h, hkv, d, layout)
    before = _kernels.LAUNCHES["flash_fwd"]
    o, lse = _fwd_kernel(q, k, v, causal, layout)
    assert _kernels.LAUNCHES["flash_fwd"] == before + 1
    ro, rlse = _fwd_plain(q, k, v, causal, layout)
    assert o.shape == q.shape and lse.shape == (b, h, sq)
    torch.testing.assert_close(o, ro, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)


def _dkv_plain(q, k, v, do, lse, delta, causal, layout):
    t = _to_bhsd(layout)
    bp = tfa._bwd_plain_at(*(t(x) for x in (q, k, v, do)), lse, delta,
                           tfa.DKV_TILE, causal)
    return tuple(t(x) for x in tfa._flash_bwd_dkv_plain(bp))


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,layout,out_f32", [
    (2, 200, 200, 8, 2, 64, True, "bshd", False),      # ragged rows, keys
    (1, 777, 777, 4, 1, 64, True, "bshd", False),
    (1, 777, 777, 8, 2, 128, False, "bshd", False),
    (2, 192, 320, 8, 2, 64, False, "bhsd", True),      # past chunk, f32
    (1, 256, 512, 4, 1, 128, False, "bhsd", True),
    (2, 512, 512, 16, 4, 128, True, "bshd", False),    # D 128, n_rep 4, 1
    (1, 384, 384, 8, 8, 128, True, "bhsd", True),
])
def test_flash_dkv_kernel_edges(cuda, b, sq, sk, h, hkv, d, causal, layout,
                                out_f32):
    q, k, v = _qkv(cuda, b, sq, sk, h, hkv, d, layout)
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    o, lse = _fwd_kernel(q, k, v, causal, layout)
    seq = 1 if layout == "bshd" else 2
    delta = tfa.attention_delta(*((o, do) if seq == 2 else
                                  (o.transpose(1, 2), do.transpose(1, 2))))
    dims = dict(seq_dim=seq, head_dim=3 - seq)
    before = _kernels.LAUNCHES["flash_bwd_dkv"]
    dk, dv = tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal=causal,
                                       out_f32=out_f32, **dims)
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == before + 1
    want = torch.float32 if out_f32 else torch.bfloat16
    assert dk.dtype == dv.dtype == want and dk.shape == dv.shape == k.shape
    rk, rv = _dkv_plain(q, k, v, do, lse, delta, causal, layout)
    _assert_grad_close(dk, rk, "dk")
    _assert_grad_close(dv, rv, "dv")


def _dq_plain(q, k, v, do, lse, delta, causal, layout, out_f32):
    t = _to_bhsd(layout)
    bp = tfa._bwd_plain_at(*(t(x) for x in (q, k, v, do)), lse, delta,
                           tfa.DQ_TILE, causal)
    return t(tfa._flash_bwd_dq_plain(
        bp, torch.float32 if out_f32 else torch.bfloat16))


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,layout,out_f32", [
    (2, 200, 200, 8, 2, 64, True, "bshd", False),      # ragged rows, keys
    (1, 777, 777, 4, 1, 64, True, "bshd", True),
    (1, 777, 777, 8, 2, 128, False, "bshd", False),
    (2, 192, 320, 8, 2, 64, False, "bhsd", True),      # past chunk, f32
    (1, 256, 512, 4, 1, 128, False, "bhsd", True),
    (2, 192, 320, 8, 2, 64, False, "bhsd", False),
    (2, 512, 512, 16, 4, 128, True, "bshd", False),    # D 128, n_rep 4, 1
    (1, 384, 384, 8, 8, 128, True, "bhsd", True),
])
def test_flash_dq_kernel_edges(cuda, b, sq, sk, h, hkv, d, causal, layout,
                               out_f32):
    q, k, v = _qkv(cuda, b, sq, sk, h, hkv, d, layout)
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    o, lse = _fwd_kernel(q, k, v, causal, layout)
    seq = 1 if layout == "bshd" else 2
    delta = tfa.attention_delta(*((o, do) if seq == 2 else
                                  (o.transpose(1, 2), do.transpose(1, 2))))
    dims = dict(seq_dim=seq, head_dim=3 - seq)
    before = _kernels.LAUNCHES["flash_bwd_dq"]
    dq = tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal=causal,
                                  out_f32=out_f32, **dims)
    assert _kernels.LAUNCHES["flash_bwd_dq"] == before + 1
    want = torch.float32 if out_f32 else torch.bfloat16
    assert dq.dtype == want and dq.shape == q.shape
    ref = _dq_plain(q, k, v, do, lse, delta, causal, layout, out_f32)
    _assert_grad_close(dq, ref, "dq")


@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_repeat_bits(cuda, d):
    # no atomics and a fixed order: a second launch gives the same bits
    q, k, v, do, lse, delta = _flash_bwd_case(cuda, 2, 640, 8, 2, d, True)
    o1, l1 = tfa._flash_fwd_kernel(q, k, v, causal=True, seq_dim=1,
                                   head_dim=2)
    o2, l2 = tfa._flash_fwd_kernel(q, k, v, causal=True, seq_dim=1,
                                   head_dim=2)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    kw = dict(causal=True, seq_dim=1, head_dim=2, out_f32=False)
    first = (tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw),
             *tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw))
    second = (tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw),
              *tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw))
    for a, r in zip(first, second):
        assert torch.equal(_bits(a), _bits(r))


def test_flash_kernels_in_a_cuda_graph(cuda):
    # one launch of each captured in a CUDA graph and replayed (as
    # chip_smoke.py's timing does) gives the eager launch's bits: the
    # tensor maps travel by value in the kernel parameters
    q, k, v, do, lse, delta = _flash_bwd_case(cuda, 2, 512, 8, 2, 64, True)
    kw = dict(causal=True, seq_dim=1, head_dim=2)
    eager = (*tfa._flash_fwd_kernel(q, k, v, **kw),
             tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                      out_f32=False, **kw),
             *tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                        out_f32=False, **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            captured = (*tfa._flash_fwd_kernel(q, k, v, **kw),
                        tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                 out_f32=False, **kw),
                        *tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                   out_f32=False, **kw))
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    for a, r in zip(captured, eager):
        assert torch.equal(_bits(a), _bits(r))


# -- 8-bit AdamW --------------------------------------------------------------


def _e4m3_limit_grad() -> float:
    """A bf16 gradient g whose first-step v = (1 - b2) g^2, divided by its
    own block scale v / 448, lands above 448 in f32: the e4m3 conversion
    must saturate to 448, not overflow."""
    g = torch.arange(0x3F00, 0x4000, dtype=torch.int32).to(torch.int16)
    g = g.view(torch.bfloat16).float()
    v = g * topt.adamw8bit().consts(1).omb2 * g
    return g[(v / (v / torch.tensor(448.0))) > 448][0].item()


def _adam8_grads(shape, dtype, gen, steps, case="random"):
    grads = []
    for _ in range(steps):
        g = torch.randn(shape, device="cuda", generator=gen) * 1e-2
        if case == "zero_block":
            g.view(-1, g.shape[-1])[0, :256] = 0.0
        if case == "e4m3_limit":
            g.view(-1, 256).mul_(0.1)[:, 0] = _e4m3_limit_grad()
        grads.append(g.to(dtype))
    return grads


def _adam8_run(shape, dtype, grads, kernel: bool, seed=0):
    """Steps with carried state through the kernel or the plain version;
    the (param, codes, scales) after every step."""
    gen = torch.Generator("cuda").manual_seed(seed)
    p = (torch.randn(shape, device="cuda", generator=gen) * 0.1).to(dtype)
    opt = topt.adamw8bit(3e-4, weight_decay=0.1)
    state = opt.init({"p": p})
    m, v = state["m"]["p"], state["v"]["p"]
    fn = topt.adam8_fused if kernel else topt.adam8_plain
    out = []
    for i, g in enumerate(grads, start=1):
        fn([(p, g, m, v)], opt.consts(i))
        out.append([t.clone() for t in (p, m.q, m.scale, v.q, v.scale)])
    return out


def _bits(t):
    if t.element_size() == 1:
        return t.view(torch.uint8)
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


A8_NAMES = ("param", "m codes", "m scales", "v codes", "v scales")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape,case", [
    ((64, 2048), "random"), ((4, 2048, 512), "random"), ((2048,), "random"),
    ((3, 77), "random"), ((5, 1000), "random"), ((), "random"),
    ((8, 512), "zero_block"), ((16, 256), "e4m3_limit")])
def test_adam8_kernel_matches_plain_bit_for_bit(cuda, dtype, shape, case):
    # (3, 77), (5, 1000) and (): whole-row blocks, the two-pass loop; the
    # rest 256-blocks in registers.  Three steps with carried state: the
    # parameter (updated in place), the codes and the scales are the same
    # bits as the plain version's (both round every operation on its
    # own), and a second run repeats them; one launch a step
    dt = DTYPES[dtype]
    grads = _adam8_grads(shape, dt, cuda, 3, case)
    before = _kernels.LAUNCHES["adam8_fused"]
    runs = [_adam8_run(shape, dt, grads, kernel=True) for _ in range(2)]
    assert _kernels.LAUNCHES["adam8_fused"] == before + 6
    plain = _adam8_run(shape, dt, grads, kernel=False)
    for step, (k1, k2, ref) in enumerate(zip(*runs, plain), start=1):
        for name, a, b, r in zip(A8_NAMES, k1, k2, ref):
            assert torch.equal(_bits(a), _bits(b)), (step, name, "repeat")
            mismatched = (_bits(a) != _bits(r)).sum().item()
            assert mismatched == 0, (step, name, mismatched)
    if case == "zero_block":
        assert plain[-1][2].view(-1)[0].item() == 1.0     # m scale guard
        assert plain[-1][4].view(-1)[0].item() == 1.0     # v scale guard
    if case == "e4m3_limit":
        v_codes = plain[0][3].view(-1, 256)[:, 0].float()
        assert torch.all(v_codes == 448.0)


def test_adam8_kernel_updates_moments_in_place(cuda):
    # p, the codes and the scales are written where they lie (the Pallas
    # kernel's input_output_aliases, then optax.apply_updates): no new
    # buffer, the same storage changed, nothing returned
    p = torch.randn(32, 512, device="cuda", generator=cuda).bfloat16()
    g = torch.randn(32, 512, device="cuda", generator=cuda).bfloat16()
    opt = topt.adamw8bit()
    state = opt.init({"p": p})
    m, v = state["m"]["p"], state["v"]["p"]
    p0 = p.clone()
    ptrs = [t.data_ptr() for t in (p, m.q, m.scale, v.q, v.scale)]
    assert topt.adam8_fused([(p, g, m, v)], opt.consts(1)) is None
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in (p, m.q, m.scale, v.q, v.scale)] == ptrs
    assert not torch.equal(p, p0)
    assert m.q.abs().max().item() == 127 and (m.scale != 1).all()
    assert v.q.float().max().item() == 448.0
    params, state = opt.apply({"p": p}, [g], state)
    assert params["p"] is p and state["m"]["p"] is m and state["count"] == 1


def test_adam8_kernel_unaligned_leaf_takes_the_row_loop(cuda):
    # a 2-byte offset: no 16-byte vector loads, the same bits
    buf = torch.empty(8 * 256 + 1, device="cuda", dtype=torch.bfloat16)
    p_k = buf[1:].view(8, 256)
    p_k.copy_(torch.randn(8, 256, device="cuda", generator=cuda))
    assert p_k.data_ptr() % 16
    p_r = p_k.clone()
    g = torch.randn(8, 256, device="cuda", generator=cuda).bfloat16()
    opt = topt.adamw8bit()
    sk, sr = opt.init({"p": p_k}), opt.init({"p": p_r})
    topt.adam8_fused([(p_k, g, sk["m"]["p"], sk["v"]["p"])], opt.consts(1))
    topt.adam8_plain([(p_r, g, sr["m"]["p"], sr["v"]["p"])], opt.consts(1))
    assert torch.equal(_bits(p_k), _bits(p_r))
    assert torch.equal(_bits(sk["v"]["p"].q), _bits(sr["v"]["p"].q))


def test_adam8_kernel_refuses(cuda):
    p = torch.randn(4, 256, device="cuda").bfloat16()
    opt = topt.adamw8bit()
    st = opt.init({"p": p})
    m, v, k = st["m"]["p"], st["v"]["p"], opt.consts(1)
    g = p.clone()
    with pytest.raises(TypeError):
        topt.adam8_fused([(p.half(), g.half(), m, v)], k)
    with pytest.raises(ValueError, match="g must match"):
        topt.adam8_fused([(p, g.float(), m, v)], k)
    with pytest.raises(ValueError, match="codes"):
        topt.adam8_fused([(p, g, v, m)], k)
    with pytest.raises(ValueError, match="scales"):
        topt.adam8_fused([(p, g, topt.QTensor(m.q, m.scale[:, :0]), v)], k)
    with pytest.raises(ValueError, match="contiguous"):
        pt = torch.randn(256, 4, device="cuda").bfloat16().t()
        topt.adam8_fused([(pt, pt.contiguous(), m, v)], k)


def test_adam8_kernel_refuses_aliasing_leaves(cuda):
    # the kernel rewrites each leaf's tensors as its own: leaves that share
    # memory are refused before any launch
    opt = topt.adamw8bit()
    buf = torch.randn(2, 512, device="cuda").bfloat16()
    st = opt.init({"a": buf[0], "b": buf[1]})
    a = (buf[0], buf[0].clone(), st["m"]["a"], st["v"]["a"])
    b = (buf[1], buf[1].clone(), st["m"]["b"], st["v"]["b"])
    before = _kernels.LAUNCHES["adam8_fused"]
    topt.adam8_fused([a, b], opt.consts(1))            # touching, not shared
    assert _kernels.LAUNCHES["adam8_fused"] == before + 1
    for leaves in ([a, (buf.view(-1)[256:768], *b[1:])],   # p's overlap
                   [(a[0], a[0], a[2], a[3])],             # g is p
                   [a, (b[0], b[1], a[2], b[3])]):         # a shared m
        with pytest.raises(ValueError, match="share no memory"):
            topt.adam8_fused(leaves, opt.consts(2))
    assert _kernels.LAUNCHES["adam8_fused"] == before + 1


def _mixed_tree(gen):
    """Leaves of every kind in one tree: bf16 and f32 256-blocks, whole-row
    blocks, a 0-d leaf, a bf16 leaf at a 2-byte offset (the row loop), and
    enough small leaves that one call takes two launches."""
    shapes = [((64, 512), torch.bfloat16), ((4, 1024, 256), torch.float32),
              ((3, 77), torch.bfloat16), ((5, 1000), torch.float32),
              ((), torch.float32), ((2048,), torch.bfloat16)]
    shapes += [((256 * (1 + i % 3),), torch.float32 if i % 2 else
                torch.bfloat16) for i in range(33)]
    params = {f"p{i}": (torch.randn(s, device="cuda", generator=gen) * 0.1
                        ).to(dt) for i, (s, dt) in enumerate(shapes)}
    buf = torch.empty(8 * 256 + 1, device="cuda", dtype=torch.bfloat16)
    params["odd"] = buf[1:].view(8, 256)
    params["odd"].copy_(torch.randn(8, 256, device="cuda", generator=gen))
    return params


def test_adam8_kernel_mixed_tree_in_one_call(cuda):
    # 40 leaves of every kind through one adam8_fused call a step: two
    # launches (32 leaves, then 8), three steps with carried state, the
    # same bits as the plain version and on a repeat
    opt = topt.adamw8bit(3e-4, weight_decay=0.1)
    start = _mixed_tree(cuda)
    assert len(start) == 40 and start["odd"].data_ptr() % 16
    grads = [[(torch.randn(p.shape, device="cuda", generator=cuda) * 1e-2
               ).to(p.dtype) for p in start.values()] for _ in range(3)]

    def run(kernel):
        params = {k: p.clone() for k, p in start.items()}
        buf = torch.empty(8 * 256 + 1, device="cuda", dtype=torch.bfloat16)
        params["odd"] = buf[1:].view(8, 256)
        params["odd"].copy_(start["odd"])
        state = opt.init(params)
        out = []
        for i, g in enumerate(grads, start=1):
            leaves = list(zip(params.values(), g, state["m"].values(),
                              state["v"].values()))
            n = _kernels.LAUNCHES["adam8_fused"]
            (topt.adam8_fused if kernel else topt.adam8_plain)(
                leaves, opt.consts(i))
            if kernel:
                assert _kernels.LAUNCHES["adam8_fused"] == n + 2
            out.append([t.clone() for p, _, m, v in leaves
                        for t in (p, m.q, m.scale, v.q, v.scale)])
        return out

    first, again, plain = run(True), run(True), run(False)
    for step, (k1, k2, ref) in enumerate(zip(first, again, plain), start=1):
        for i, (a, b, r) in enumerate(zip(k1, k2, ref)):
            what = (step, list(start)[i // 5], A8_NAMES[i % 5])
            assert torch.equal(_bits(a), _bits(b)), (*what, "repeat")
            assert torch.equal(_bits(a), _bits(r)), what


@pytest.mark.parametrize("case,axes", [
    # 128-wide shards of 256-blocks: straddled, stepped on gathered rows
    ("straddled", dict(fsdp=2, tensor=4)),
    # 256-wide shards: whole blocks, stepped per shard
    ("per_shard", dict(fsdp=2, tensor=2)),
])
def test_adam8_kernel_on_virtual_shards_is_the_whole_leaf_sliced(cuda, case,
                                                                 axes):
    # a bf16 [1024, 512] leaf cut (fsdp, tensor) over virtual ranks in one
    # process (optim8bit.update_virtual_ranks), two steps, one kernel
    # launch a rank a step: each rank's p, codes and scales the same bits
    # as its slice of the whole leaf stepped by the kernel
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    spec = ("fsdp", "tensor")
    opt = topt.adamw8bit(3e-4, weight_decay=0.1)
    whole = (torch.randn(1024, 512, device="cuda", generator=cuda) * 0.1
             ).bfloat16()
    grads = [(torch.randn(whole.shape, device="cuda", generator=cuda) * 1e-2
              ).bfloat16() for _ in range(2)]
    plan = plan_axes(2 * axes["tensor"], **axes)
    ranks = []
    for f in range(2):
        for t in range(axes["tensor"]):
            coord = MeshCoord(plan, {"fsdp": f, "tensor": t})
            p = tllama.shard_leaf(whole, spec, coord).clone()
            ropt = topt.adamw8bit(3e-4, weight_decay=0.1, mesh=coord,
                                  param_specs={"w": spec})
            ranks.append((coord, p, ropt, ropt.init({"w": p})))
    want = {"p": whole.clone()}
    want_state = opt.init(want)
    for step, g in enumerate(grads, start=1):
        topt.adam8_fused([(want["p"], g, want_state["m"]["p"],
                           want_state["v"]["p"])], opt.consts(step))
        before = _kernels.LAUNCHES["adam8_fused"]
        topt.update_virtual_ranks([
            (coord, [(p, tllama.shard_leaf(g, spec, coord), st["m"]["w"],
                      st["v"]["w"])], [ropt.plans({"w": p})["w"]])
            for coord, p, ropt, st in ranks], opt.consts(step))
        assert _kernels.LAUNCHES["adam8_fused"] == before + len(ranks)
    gathered = case == "straddled"
    for coord, p, ropt, st in ranks:
        assert (ropt.plans({"w": p})["w"] == "tensor") == gathered
        sspec = ropt.state_specs({"w": p}, {"w": spec})["m"]["w"]
        m, v = st["m"]["w"], st["v"]["w"]
        wm, wv = want_state["m"]["p"], want_state["v"]["p"]
        for name, got, ref, sp in (
                ("param", p, want["p"], spec), ("m codes", m.q, wm.q, spec),
                ("m scales", m.scale, wm.scale, sspec.scale),
                ("v codes", v.q, wv.q, spec),
                ("v scales", v.scale, wv.scale, sspec.scale)):
            assert torch.equal(_bits(got),
                               _bits(tllama.shard_leaf(ref, sp, coord))), (
                coord.coord, name)


def test_adam8_step_captured_in_a_cuda_graph(cuda):
    # one optimizer step captured in a CUDA graph (the leaf table is a
    # kernel parameter, captured by value) and replayed gives the bits of
    # the same step run eagerly from the same state
    opt = topt.adamw8bit(3e-4, weight_decay=0.1)
    shapes = [(64, 512), (3, 77), (2048,)]
    params = {f"p{i}": (torch.randn(s, device="cuda", generator=cuda) * 0.1
                        ).bfloat16() for i, s in enumerate(shapes)}
    grads = [(torch.randn(p.shape, device="cuda", generator=cuda) * 1e-2
              ).bfloat16() for p in params.values()]
    warm = {k: p.clone() for k, p in params.items()}
    opt.apply(warm, grads, opt.init(warm))   # builds, sizes the grid
    eager = {k: p.clone() for k, p in params.items()}
    eager_state = opt.init(eager)
    opt.apply(eager, grads, eager_state)
    state = opt.init(params)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.apply(params, grads, state)
    graph.replay()
    torch.cuda.synchronize()
    for k in params:
        assert torch.equal(_bits(params[k]), _bits(eager[k])), k
        for side_name in ("m", "v"):
            got, want = state[side_name][k], eager_state[side_name][k]
            assert torch.equal(_bits(got.q), _bits(want.q)), (k, side_name)
            assert torch.equal(got.scale, want.scale), (k, side_name)


def test_adam8_train_step_on_card_matches_cpu(cuda):
    # the adam8bit step on the card (flash, RMSNorm and 8-bit AdamW
    # kernels) against the CPU (plain versions), three steps from the same
    # weights: one adam8_fused launch per step for all 12 leaves; losses
    # within bf16 rounding order, and the weights within 3 steps * 2 * lr
    # plus a bf16 ulp (gradients that differ in their last bits may move a
    # code)
    cfg = dataclasses.replace(
        tllama.LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=512, max_seq=256),
        remat=True, remat_policy="ffn", xent_chunk=64)
    params = tllama.init_params(cfg, cuda, "cuda")
    # the CPU copy first: the card's steps update ``params`` in place
    start = {"cuda": params, "cpu": tllama.params_to(params, "cpu")}
    tokens = torch.randint(0, 512, (2, 129), device="cuda", generator=cuda)
    out = {}
    for dev, p in start.items():
        step, _, opt = tllama.make_train_step(cfg, optimizer="adam8bit",
                                              device=dev)
        state = opt.init(p)
        losses = []
        _kernels.reset_launches()
        for _ in range(3):
            p, state, loss = step(p, state, tokens.to(dev))
            losses.append(loss.item())
        if dev == "cuda":                 # one launch for the 12 leaves
            assert _kernels.LAUNCHES["adam8_fused"] == 3
        out[dev] = (losses, tllama.params_to(p, "cpu"))
    for lc, lp in zip(out["cuda"][0], out["cpu"][0]):
        assert abs(lc - lp) < 1e-2 * abs(lp)
    for a, b in zip(tllama.training.tree_leaves(out["cuda"][1]),
                    tllama.training.tree_leaves(out["cpu"][1])):
        err = (a.float() - b.float()).abs()
        assert torch.all(err <= 6 * 3e-4 + 2.0 ** -8 * b.float().abs())


# -- the MoE model on the card --------------------------------------------------


@pytest.mark.parametrize("case", ["random", "tied"])
def test_moe_route_on_card_is_the_cpu_route(cuda, case):
    # integer cumulative sums and a stable sort: the capacity positions,
    # drops and tie-breaks are exact, the normalized gate values divide
    # two f32 tensors (correctly rounded on both): the same bits as the
    # CPU, and on a repeat
    if case == "tied":
        probs = torch.full((2, 512, 8), 0.125, device="cuda")
    else:
        probs = torch.softmax(torch.randn(2, 512, 8, device="cuda",
                                          generator=cuda) * 2, -1)
    cap = tmoe.MoEConfig.small().capacity(512)
    d, c = tmoe.route(probs, 2, cap)
    d2, c2 = tmoe.route(probs, 2, cap)
    rd, rc = tmoe.route(probs.cpu(), 2, cap)
    assert torch.equal(d.cpu(), rd) and torch.equal(c.cpu(), rc)
    assert torch.equal(d, d2) and torch.equal(c, c2)
    if case == "tied":          # ties go to experts 0 and 1, which overflow
        assert int(rd.sum()) < 2 * 2 * 512


def test_moe_train_step_on_card_matches_cpu(cuda):
    # a 2-layer MoE at head_dim 128 (flash at the MoE's D) under "dots"
    # remat and adamw8bit on the card (kernels 1 to 6) against the CPU
    # (plain versions), one step from the same weights: the launches of
    # kernels 1 to 5 as chip_smoke.py's remat_launches, one update launch
    # for the 13 leaves, the loss within 1% (a routing flip at a near-tie
    # moves one token's loss term, not the mean's first digits)
    cfg = tmoe.MoEConfig(vocab_size=512, hidden=256, layers=2, heads=2,
                         kv_heads=1, ffn=384, experts=4, max_seq=256)
    params = tmoe.init_params(cfg, cuda, "cuda")
    start = {"cuda": params, "cpu": tllama.params_to(params, "cpu")}
    tokens = torch.randint(0, 512, (2, 129), device="cuda", generator=cuda)
    losses = {}
    for dev, p in start.items():
        step, _, opt = tmoe.make_train_step(cfg, optimizer="adam8bit",
                                            device=dev)
        state = opt.init(p)
        _kernels.reset_launches()
        p, state, loss = step(p, state, tokens.to(dev))
        losses[dev] = loss.item()
        if dev == "cuda":
            n = cfg.layers
            assert dict(_kernels.LAUNCHES) == {
                "flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "rms_norm_fwd": 4 * n + 1, "rms_norm_bwd": 2 * n + 1,
                "adam8_fused": 1, "decode_attn": 0, "adamw_fused": 0}
    assert abs(losses["cuda"] - losses["cpu"]) < 1e-2 * losses["cpu"]


@pytest.mark.parametrize("case", ["starved_shard", "capacity_1"])
@pytest.mark.parametrize("shards", [2, 4])
def test_expert_sharded_ffn_on_card_is_the_unsplit_ffn(cuda, case, shards):
    # the MoE FFN split over virtual expert shards in one process (each
    # shard its experts' slice of the leaves and of dispatch/combine, the
    # partials summed) against the unsplit FFN, in bf16 at moe-small's
    # expert shape cut to 512 tokens: "starved_shard" zeroes the router, so
    # every token ties to experts 0 and 1, which overflow, and the shards
    # past the first receive no token (their output and expert gradients
    # exactly zero); "capacity_1" keeps one token per expert a row and
    # drops the rest.  Out and gradients within 1% in relative norm (the
    # partials are rounded to bf16 before their sum, and one bf16 rounding
    # may flip between summation orders)
    base = tmoe.MoEConfig.small()
    cfg = dataclasses.replace(
        base, layers=1, capacity_factor=1e-3 if case == "capacity_1"
        else base.capacity_factor)
    params = tmoe.init_params(cfg, cuda, "cuda")
    lp = {k: params["layers"][k][0].detach().clone()
          for k in ("router", "w_gate", "w_up", "w_down")}
    if case == "starved_shard":
        lp["router"].zero_()
    leaves = [t.requires_grad_() for t in lp.values()]
    y = torch.randn(2, 256, cfg.hidden, device="cuda",
                    generator=cuda).bfloat16().requires_grad_()
    dy = torch.randn(2, 256, cfg.hidden, device="cuda",
                     generator=cuda).bfloat16()
    if case == "capacity_1":
        assert cfg.capacity(256) == 1
    ref, aux_ref = tmoe._moe_ffn(cfg, lp, y)
    grads_ref = torch.autograd.grad((ref * dy).sum() + aux_ref, [y, *leaves])
    out, aux = tmoe.ffn_over_expert_shards(cfg, lp, y, shards)
    grads = torch.autograd.grad((out * dy).sum() + aux, [y, *leaves])
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(aux, aux_ref)
    for name, g, r in zip(("y", *lp), grads, grads_ref):
        assert _rel(g, r) <= 1e-2, name
    if case == "starved_shard":
        per = cfg.experts // shards
        for name in ("w_gate", "w_up", "w_down"):
            g = grads[1 + list(lp).index(name)]
            assert not g[per:].any(), name      # no token reached them


# -- the mesh: the ring's per-chunk schedule and the collectives -------------


@pytest.mark.parametrize("d", [64, 128])
def test_ring_chunks_ragged_match_dense_flash(cuda, d):
    # three chunks of 200 rows (ragged tiles, masked) driven in one
    # process through the ring's per-step body, against the dense kernels
    # over all 600: n(n+1)/2 chunk launches each way
    from tpu_network_operator_torch.parallel import ring

    n, s = 3, 200
    q, k, v = _qkv(cuda, 1, n * s, n * s, 8, 2, d)
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    qs, ks, vs, dos = (list(t.chunk(n, dim=1)) for t in (q, k, v, do))
    _kernels.reset_launches()
    outs, lses = ring.ring_forward_chunks(qs, ks, vs, "flash")
    assert _kernels.LAUNCHES["flash_fwd"] == n * (n + 1) // 2
    dq, dk, dv = ring.ring_backward_chunks(qs, ks, vs, outs, lses, dos,
                                           "flash")
    assert _kernels.LAUNCHES["flash_bwd_dq"] == n * (n + 1) // 2
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == n * (n + 1) // 2
    ro, rlse = tfa._flash_fwd_kernel(q, k, v, causal=True, seq_dim=1,
                                     head_dim=2)
    torch.testing.assert_close(torch.cat(outs, dim=1), ro, rtol=0,
                               atol=2e-2)
    torch.testing.assert_close(torch.cat(lses, dim=2), rlse, rtol=0,
                               atol=1e-4)
    delta = tfa.attention_delta(ro.transpose(1, 2), do.transpose(1, 2))
    kw = dict(causal=True, seq_dim=1, head_dim=2, out_f32=True)
    rdq = tfa._flash_bwd_dq_kernel(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = tfa._flash_bwd_dkv_kernel(q, k, v, do, rlse, delta, **kw)
    for name, t, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        _assert_grad_close(torch.cat(t, dim=1), r, name)


def test_ring_step_on_a_past_chunk_longer_than_its_queries(cuda):
    # Sk != Sq on a strictly-past chunk, both ragged: the kernels' masked
    # tiles, held to the plain versions at the kernels' tiles
    from tpu_network_operator_torch.parallel import ring

    q, k, v = _qkv(cuda, 2, 200, 328, 8, 2, 128, layout="bhsd")
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    engine = ring._Flash(328)      # blocks that take both lengths
    o, lse = ring.fwd_step(engine, q, k, v, 0, 1, None)
    ro, rlse = tfa._flash_fwd_plain_at_tiles(q, k, v, causal=False)
    torch.testing.assert_close(o, ro.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    delta = tfa.attention_delta(o, do)
    grads = ring.bwd_step(engine, q, k, v, do, lse, delta, 0, 1, *(
        torch.zeros_like(t, dtype=torch.float32) for t in (q, k, v)))
    refs = tfa._flash_bwd_plain_at_tiles(q, k, v, do, lse, delta,
                                         causal=False)
    for name, t, r in zip(("dq", "dk", "dv"), grads, refs):
        _assert_grad_close(t, r, name)


def test_collectives_on_a_world1_nccl_group_are_identities(cuda, tmp_path):
    import torch.distributed as dist

    from tpu_network_operator_torch.parallel import comm

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        g = dist.group.WORLD
        x = torch.randn(4, 6, 8, device="cuda", generator=cuda)
        for name, fn in (
                ("split", lambda t: comm.split(t, g, 1)),
                ("gather", lambda t: comm.gather(t, g, 1)),
                ("gather_sum", lambda t: comm.gather_sum(t, g, 2)),
                ("copy_to", lambda t: comm.copy_to(t, g)),
                ("reduce_from", lambda t: comm.reduce_from(t, g)),
                ("all_to_all", lambda t: comm.all_to_all(t, g, 2, 1))):
            t = x.clone().requires_grad_()
            y = fn(t)
            (gx,) = torch.autograd.grad(y, t, 2 * x)
            torch.cuda.synchronize()
            assert torch.equal(y, x), name
            assert torch.equal(gx, 2 * x), name
        assert torch.equal(comm.all_reduce(x, g), x)
        assert torch.equal(comm.reduce_scatter(x, g, 1), x)
        assert torch.equal(comm.all_gather(x, g, 2), x)
    finally:
        dist.destroy_process_group()


def test_pipeline_in_process_repeats_its_loss_bits(cuda):
    """A 2-layer Llama at head_dim 64 (flash) through the pipeline's
    executor over 2 stages in one process, 1f1b with 4 microbatches: a
    repeat gives the same loss and gradient bits (the flash backward and
    RMSNorm backward kernels are deterministic and the schedule's order
    is fixed), and every flash and RMSNorm kernel of the path launched."""
    from tpu_network_operator_torch.models import training
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), hidden=256,
                              heads=4, kv_heads=2, ffn=512, layers=2,
                              remat=True, remat_policy="full")
    step, init_all, _ = tpipe.make_pipeline_train_step(
        cfg, None, 4, schedule="1f1b", device="cuda", stages_in_process=2)
    params, _ = init_all(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (4, 257), device="cuda",
                           generator=cuda)
    _kernels.reset_launches()
    runs = [step.grads_fn(params, tokens) for _ in range(2)]
    per_run = {k: v // 2 for k, v in _kernels.LAUNCHES.items()}
    (loss0, g0), (loss1, g1) = runs
    assert torch.equal(loss0, loss1)
    for a, b in zip(training.tree_leaves(g0), training.tree_leaves(g1)):
        assert torch.equal(a, b)
    # per microbatch and layer: flash forward twice (full remat replays
    # it), its two backward kernels once; RMSNorm as the plain step
    n, m = cfg.layers, 4
    assert per_run["flash_fwd"] == 2 * n * m
    assert per_run["flash_bwd_dq"] == per_run["flash_bwd_dkv"] == n * m
    assert per_run["rms_norm_fwd"] == (4 * n + 1) * m
    assert per_run["rms_norm_bwd"] == (2 * n + 1) * m


def test_entry_forward_repeats_its_bits(cuda):
    """``graft.entry()``'s flagship forward on the card: logits [2, 128,
    32000], finite, the same bits on a repeat (the flash forward and
    RMSNorm forward kernels sum in fixed orders), both kernels launched."""
    from tpu_network_operator_torch import graft

    fn, args = graft.entry()
    _kernels.reset_launches()
    first = fn(*args)
    again = fn(*args)
    assert first.shape == (2, 128, 32_000)
    assert bool(torch.isfinite(first).all())
    assert torch.equal(first, again)
    assert _kernels.LAUNCHES["flash_fwd"] == 2 * 8
    assert _kernels.LAUNCHES["rms_norm_fwd"] == 2 * (2 * 8 + 1)


def test_dryrun_world1_repeats_section_1b_bits(cuda):
    """``graft.dryrun_multichip(1)`` twice at a world of one: section 1b's
    losses (every kernel on the mesh path, the second step's after the
    backward kernels and the 8-bit update) the same bits each run, those
    on random tokens within the reference's budget of the plain steps on
    the CPU, each of the six training kernels launched in it, and neither
    the decode kernel (the dry run trains and never decodes) nor kernel 8
    (the section steps with adamw8bit)."""
    from tpu_network_operator_torch import graft

    runs = [graft.dryrun_multichip(1) for _ in range(2)]
    first, again = (r["sections"]["1b"] for r in runs)
    for key in ("loss", "next_loss", "drift_losses"):
        assert first[key] == again[key], key
    assert first["drift"] < graft.DRIFT_TOL
    trained = dict(first["launches"])
    assert trained.pop("decode_attn") == 0, first["launches"]
    assert trained.pop("adamw_fused") == 0, first["launches"]
    assert all(n > 0 for n in trained.values()), first["launches"]
    assert runs[0]["lines"][-1] == graft.OK_LINE


@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (1, 8192, 32, 4, 128, 1024),   # the Mellum2 cell's sliding layers
    (1, 1000, 8, 2, 64, 200),      # a ragged last tile, window off the tile
    (2, 512, 4, 4, 128, 129),      # a band edge one key past a tile
    (1, 384, 8, 1, 64, 64),        # a window under a forward tile
    (1, 640, 4, 2, 128, 3),        # the diagonal and two keys below it
])
def test_flash_window_kernels_match_plain(cuda, b, s, h, hkv, d, window):
    q, k, v = _qkv(cuda, b, s, s, h, hkv, d)
    do = torch.randn(q.shape, device="cuda", generator=cuda).bfloat16()
    o, lse = tfa._flash_fwd_kernel(q, k, v, causal=True, seq_dim=1,
                                   head_dim=2, window=window)
    t = [x.transpose(1, 2) for x in (q, k, v, do)]
    ro, rlse = tfa._flash_fwd_plain_at_tiles(*t[:3], causal=True,
                                             window=window)
    torch.testing.assert_close(o, ro.transpose(1, 2), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    delta = tfa.attention_delta(o.transpose(1, 2), do.transpose(1, 2))
    kw = dict(causal=True, seq_dim=1, head_dim=2, out_f32=False,
              window=window)
    dq = tfa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    refs = tfa._flash_bwd_plain_at_tiles(*t, lse, delta, causal=True,
                                         dq_dtype=torch.bfloat16,
                                         window=window)
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        _assert_grad_close(out, ref.transpose(1, 2), name)


def test_flash_window_refused_without_causal(cuda):
    q, k, v = _qkv(cuda, 1, 128, 128, 2, 1, 64)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, causal=False, window=16)


@pytest.mark.parametrize("rows,experts,h,f", [(32768, 64, 2304, 896),
                                              (1000, 8, 256, 128)])
def test_grouped_mm_matches_per_expert_loop(cuda, rows, experts, h, f):
    """The dropless route's grouped GEMM (one ``torch._grouped_mm``) against
    one ``mm`` an expert, forward and both gradients, with uneven groups
    and an empty one."""
    from tpu_network_operator_torch.ops import grouped_gemm as tgg

    expert = torch.randint(0, experts, (rows,), device="cuda", generator=cuda)
    counts = torch.bincount(expert.masked_fill(expert == 1, 0),
                            minlength=experts)
    ends = torch.cumsum(counts, 0).to(torch.int32)
    x = torch.randn(rows, h, device="cuda", generator=cuda).bfloat16()
    w = (torch.randn(experts, h, f, device="cuda", generator=cuda)
         / h ** 0.5).bfloat16()
    gy = torch.randn(rows, f, device="cuda", generator=cuda).bfloat16()
    got, want = [], []
    for fn, out in ((tgg.grouped_mm, got), (tgg._grouped_mm_plain, want)):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xs, ws, ends)
        out.extend([y, *torch.autograd.grad(y, (xs, ws), gy)])
    for name, a, r in zip(("y", "dx", "dw"), got, want):
        _assert_grad_close(a, r, name)


# -- kernel 8: the fused AdamW update --------------------------------------

ADAMW_CASES = {
    # the mistral-7b-l24 cell's leaves (embed, a stacked FFN leaf cut to 2
    # layers, wq, wk, a layer norm, the final norm): the vector path
    "cell": [((32768, 4096), "bf16", 0), ((2, 4096, 14336), "bf16", 0),
             ((2, 4096, 4096), "bf16", 0), ((2, 4096, 1024), "bf16", 0),
             ((2, 4096), "bf16", 0), ((4096,), "bf16", 0)],
    # short last units (91, 5 and 15 values), a parameter 2 bytes off its
    # buffer's start and a gradient 4 bytes off (a view into a flat
    # all-reduce buffer): the scalar loop
    "tail": [((7, 13), "bf16", 0), ((5,), "f32", 0), ((3, 5), "f16", 0),
             ((8, 257), "bf16", 1), ((4, 300), "bf16", -2),
             ((1000,), "f32", 0)],
    # one tree of every (p, g) pair the port hands the optimizer: bf16 (the
    # model), f32 (the MoE router, f32 configs), f16 (f16 configs)
    "mixed": [((256, 1024), "bf16", 0), ((2, 1024, 8), "f32", 0),
              ((3, 1000), "f16", 0), ((4096,), "bf16", 0),
              ((64, 64), "f32", 0)],
}
ADAMW_NAMES = ("p", "m", "v")


def _offset(shape, dtype, offset, gen=None):
    """A ``shape`` tensor starting ``offset`` elements into a fresh buffer
    (a view; 0: the tensor itself), of random values drawn from ``gen``
    (None: not set)."""
    n = math.prod(shape) + offset
    buf = (torch.empty(n, device="cuda", dtype=dtype) if gen is None else
           torch.randn(n, device="cuda", generator=gen).to(dtype))
    return buf[offset:].view(shape)


def _adamw_case(case, gen):
    """(params, three steps' gradients) of a case, the offsets taken: a
    positive offset moves the parameter, a negative one the gradients."""
    params, grads = {}, [[] for _ in range(3)]
    for i, (shape, dtype, off) in enumerate(ADAMW_CASES[case]):
        dt = DTYPES[dtype]
        params[f"p{i}"] = _offset(shape, dt, max(off, 0), gen).mul_(0.05)
        for step in grads:
            g = _offset(shape, dt, max(-off, 0), gen).mul_(1e-3 * (i + 1))
            g.view(-1)[: g.numel() // 8] = 0      # an absent token's rows
            step.append(g)
    return params, grads


def _adamw_run(params, grads, kernel):
    """Three steps with carried state through the kernel or the eager
    sequence, on copies of ``params`` (offsets kept): p, m and v after
    every step."""
    params = {k: _offset(p.shape, p.dtype, p.storage_offset()).copy_(p)
              for k, p in params.items()}
    opt = ttrain.AdamW(3e-4, weight_decay=0.1)
    state = opt.init(params)
    out = []
    for i, g in enumerate(grads, start=1):
        leaves = list(zip(params.values(), g, state["mu"].values(),
                          state["nu"].values()))
        consts = opt.consts(i, {p.dtype for p in params.values()})
        n = _kernels.LAUNCHES["adamw_fused"]
        (ttrain.adamw_fused if kernel else ttrain.adamw_plain)(leaves, consts)
        assert _kernels.LAUNCHES["adamw_fused"] == n + int(kernel)
        out.append([t.clone() for leaf in leaves
                    for t in (leaf[0], leaf[2], leaf[3])])
    return out


def _mismatch(a, b) -> str:
    bad = (_bits(a) != _bits(b)).reshape(-1).nonzero()[:4, 0]
    return (f"{int((_bits(a) != _bits(b)).sum())} of {a.numel()} differ, "
            f"first at {bad.tolist()}: {a.reshape(-1)[bad].tolist()} "
            f"against {b.reshape(-1)[bad].tolist()}")


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_kernel_matches_eager_bit_for_bit(cuda, case):
    # three steps with carried state: the kernel's p, m and v are the eager
    # CUDA sequence's bits (adamw_plain on the card), and a repeat's
    params, grads = _adamw_case(case, cuda)
    if case == "tail":
        assert params["p3"].data_ptr() % 16 and grads[0][4].data_ptr() % 16
    first, again, eager = (_adamw_run(params, grads, kernel)
                           for kernel in (True, True, False))
    for step, (k1, k2, ref) in enumerate(zip(first, again, eager), start=1):
        for i, (a, b, r) in enumerate(zip(k1, k2, ref)):
            what = (step, f"p{i // 3}", ADAMW_NAMES[i % 3])
            assert torch.equal(_bits(a), _bits(b)), (*what, "repeat")
            assert torch.equal(_bits(a), _bits(r)), (*what, _mismatch(a, r))


def test_adamw_apply_steps_the_tree_in_one_launch(cuda):
    # AdamW.apply on a CUDA tree (bf16 leaves and an f32 one): one
    # adamw_fused launch a step, the eager sequence's bits, the same
    # objects back, and the counter of stepped values equal to the tree's
    from torch.profiler import ProfilerActivity, profile

    params, grads = _adamw_case("mixed", cuda)
    eager = _adamw_run(params, grads, kernel=False)
    opt = ttrain.AdamW(3e-4, weight_decay=0.1)
    state = opt.init(params)
    tracing.reset_counters()
    try:
        for step, g in enumerate(grads):
            n = _kernels.LAUNCHES["adamw_fused"]
            with profile(activities=[ProfilerActivity.CPU]):
                out = opt.apply(params, g, state)
            assert out[0] is params and out[1] is state
            assert _kernels.LAUNCHES["adamw_fused"] == n + 1
            got = [t for p, m, v in zip(params.values(),
                                        state["mu"].values(),
                                        state["nu"].values())
                   for t in (p, m, v)]
            assert all(torch.equal(_bits(a), _bits(r))
                       for a, r in zip(got, eager[step])), step
        assert state["count"] == 3
        assert tracing.counters() == {"optim.adamw_fused_elems": 3 * sum(
            p.numel() for p in params.values())}
    finally:
        tracing.reset_counters()
