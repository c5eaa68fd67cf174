"""The port's hybrid-attention MoE (Mellum2's block) on the CPU: an explicit
head dim, sliding-window layers beside full ones, YaRN on the full layers
and dropless top-k routing, held to the benchmark's plain reference
(``portbench/reference/hybrid_moe.py``) at a tiny size; the window in the
flash kernels' plain versions; YaRN against transformers; the refusals;
and the capacity path's outputs for a fixed seed, as they were before
dropless routing came.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import types

import pytest
import torch

from portbench import weights
from portbench.drivers import train_hybrid
from portbench.reference import hybrid_moe as ref
from portbench.reference import model as ref_model
from tpu_network_operator_torch.models import convert, llama, moe
from tpu_network_operator_torch.ops import flash_attention as fa
from tpu_network_operator_torch.ops import grouped_gemm, rope
from tpu_network_operator_torch.ops.attention import causal_attention
from tpu_network_operator_torch.parallel.mesh import MeshCoord, plan_axes

SEED = 2 ** 31 + 321
CONFIG = "portbench/configs/mellum2-l16.json"


def tiny_config(window: int = 8, experts: int = 8, top: int = 3) -> dict:
    """The Mellum2 configuration at tiny widths: head dim 32 where hidden
    / heads is 16, 3 sliding layers and a full one, YaRN with an original
    context of 8 and factor 4 (its attention factor derived), 8 experts,
    top-3."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=32, vocab_size=256, num_hidden_layers=4,
               moe_intermediate_size=32, num_experts=experts,
               num_experts_per_tok=top, sliding_window=window,
               max_position_embeddings=64)
    cfg["layer_types"] = cfg["layer_types"][:4]
    cfg["mlp_layer_types"] = cfg["mlp_layer_types"][:4]
    full = cfg["rope_parameters"]["full_attention"]
    full.update(original_max_position_embeddings=8, factor=4)
    del full["attention_factor"]
    return cfg


def port_f32(cfg):
    pcfg = train_hybrid.port_config(cfg, {"remat_policy": "full",
                                          "xent_chunk": 0})
    return dataclasses.replace(pcfg, dtype=torch.float32, remat=False)


def leaves_f32(draws):
    return {k: ({n: t.float().requires_grad_() for n, t in v.items()}
                if isinstance(v, dict) else v.float().requires_grad_())
            for k, v in draws.items()}


# -- the model against the reference ------------------------------------------


def test_config_geometry():
    cfg = tiny_config()
    pcfg = port_f32(cfg)
    assert pcfg.head_dim == 32 != pcfg.hidden // pcfg.heads
    assert llama.layer_windows(pcfg) == [8, 8, 8, 0]
    assert moe.MoEConfig().head_dim == 4096 // 32       # derived by default
    assert moe.HybridMoEConfig().head_dim == 4096 // 32
    assert llama.LlamaConfig.tiny().head_dim == 16
    assert llama.HybridLlamaConfig(explicit_head_dim=64).head_dim == 64
    with open(CONFIG) as f:
        full = train_hybrid.port_config(json.load(f), {
            "remat_policy": "full", "xent_chunk": 1024})
    assert llama.layer_windows(full).count(1024) == 12
    assert round(full.num_params() / 1e6, 1) == 7136.9


def test_hybrid_logits_loss_and_grads_match_reference():
    cfg = tiny_config()
    pcfg = port_f32(cfg)
    view = ref.leaf_view(cfg)
    draws = weights.draw(view, SEED, "cpu")
    tokens = weights.token_rows(SEED, 1, 2, 33, cfg["vocab_size"], "cpu")[0]
    pp = leaves_f32(draws)
    with torch.no_grad():
        logits, _ = moe.forward(pp, tokens[:, :-1], pcfg)
        rp = ref_model.from_leaves(draws)
        x, _ = ref.hidden(cfg, rp, tokens[:, :-1], "f32", False)
        want = x @ rp["lm_head"]
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    loss = moe.loss_fn(pp, tokens, pcfg)
    loss.backward()
    rp = ref_model.from_leaves(draws, requires_grad=True)
    rloss = ref.loss(cfg, rp, tokens, chunk=16)
    rloss.backward()
    assert float(loss) == pytest.approx(float(rloss), rel=1e-6)
    groups = ref_model.leaf_groups(rp)
    for path, p in weights.flat(pp).items():
        rg = torch.stack([t.grad for t in groups[path]]).reshape(p.shape)
        err = float((rg - p.grad).norm() / p.grad.norm().clamp_min(1e-30))
        assert err < 1e-4, (path, err)


def test_window_changes_the_model():
    """The window and YaRN are live at this size: dropping either moves
    the loss."""
    cfg = tiny_config()
    pcfg = port_f32(cfg)
    pp = leaves_f32(weights.draw(ref.leaf_view(cfg), SEED, "cpu"))
    tokens = weights.token_rows(SEED, 1, 2, 33, cfg["vocab_size"], "cpu")[0]
    with torch.no_grad():
        base = float(moe.loss_fn(pp, tokens, pcfg))
        for other in (dataclasses.replace(pcfg, layer_types=(),
                                          sliding_window=0),
                      dataclasses.replace(pcfg, rope_parameters=())):
            assert abs(float(moe.loss_fn(pp, tokens, other)) - base) > 1e-4


# -- the window in the flash kernels' plain versions --------------------------


def _qkv(seed, s, h=4, hkv=2, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(1, s, n, d, generator=g).to(dtype)
            for n in (h, hkv, hkv)]


def _rel(a, b):
    """The gap's norm over the reference's, or over 1 where the reference
    is smaller (a window of one key gives dQ 0)."""
    return float((a.float() - b.float()).norm()
                 / max(float(b.float().norm()), 1.0))


@pytest.mark.parametrize("window,bq,bk", [(2, 16, 16), (5, 16, 8),
                                          (8, 8, 32), (13, 16, 16),
                                          (40, 16, 8), (64, 32, 32),
                                          (100, 16, 16)])
def test_flash_window_plain_matches_masked_attention(window, bq, bk):
    """Forward, dQ and dK/dV of the blockwise plain versions against plain
    masked attention; windows off the block sizes put the band's edge
    inside blocks, 100 > S is the causal mask."""
    q, k, v = _qkv(window, 64)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    got, want = [], []
    for fn, out in ((lambda a, b, c: fa.flash_attention(
            a, b, c, block_q=bq, block_k=bk, window=window), got),
            (lambda a, b, c: causal_attention(a, b, c, window=window),
             want)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        out.extend([o, *torch.autograd.grad(o, leaves, do)])
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        # the plain versions round q * scale, P and dS to bf16 as the
        # kernels do
        assert _rel(a, b) < 1e-2, (name, _rel(a, b))


@pytest.mark.parametrize("window", [128, 129, 200, 384])
def test_flash_window_plain_at_kernel_tiles(window):
    """The references the kernels are held to on the card: at the kernels'
    tiles (128 / 64 rows and keys) on 512 positions, band edges inside
    tiles and on them."""
    q, k, v = _qkv(window, 512, d=64, dtype=torch.bfloat16)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    t = [x.transpose(1, 2) for x in (q, k, v, do.bfloat16())]
    o, lse = fa._flash_fwd_plain_at_tiles(*t[:3], causal=True, window=window)
    want = causal_attention(q.float(), k.float(), v.float(), window=window)
    assert _rel(o.transpose(1, 2), want) < 1e-2
    delta = fa.attention_delta(o, t[3])
    grads = fa._flash_bwd_plain_at_tiles(*t, lse, delta, causal=True,
                                         window=window)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    dense = torch.autograd.grad(causal_attention(*leaves, window=window),
                                leaves, do.bfloat16().float())
    for name, a, b in zip(("dq", "dk", "dv"), grads, dense):
        assert _rel(a.transpose(1, 2), b) < 2e-2, (name, _rel(a, b))


def test_flash_window_skips_blocks_below_the_band():
    q, k, v = (t.transpose(1, 2) for t in _qkv(0, 64, d=16))
    bp = fa._BwdPlain(q, k, v, torch.zeros_like(q), torch.zeros(1, 4, 64),
                      torch.zeros(1, 4, 64), 16, 16, True, 20)
    # q block 3 (rows 48..63) sees keys 29..63: blocks 1 to 3
    assert fa._first_block(3, 16, 16, 20) == 1
    assert [bp.live(3, j) for j in range(4)] == [False, True, True, True]
    assert fa._first_block(3, 16, 16, 0) == 0
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(*_qkv(0, 64), block_q=16, block_k=16,
                           causal=False, window=8)


# -- YaRN -----------------------------------------------------------------------


MELLUM_YARN = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
               "original_max_position_embeddings": 8192, "beta_fast": 32,
               "beta_slow": 1, "attention_factor": 1.2772588722239782}


@pytest.mark.parametrize("spec,dim", [
    (MELLUM_YARN, 128),
    ({"rope_type": "yarn", "rope_theta": 500000, "factor": 4,
      "original_max_position_embeddings": 8}, 32),
    ({"rope_type": "yarn", "rope_theta": 10000.0, "factor": 8.0}, 64)])
def test_yarn_matches_the_published_formula(spec, dim):
    """The port's and the reference's YaRN against transformers'
    ``_compute_yarn_parameters`` (installed here), and the attention
    factor on the port's cos and sin."""
    init = pytest.importorskip("transformers.modeling_rope_utils")
    hf = types.SimpleNamespace(rope_theta=spec["rope_theta"], head_dim=dim,
                               hidden_size=dim, num_attention_heads=1,
                               max_position_embeddings=4096,
                               rope_scaling=spec)
    want, factor = init.ROPE_INIT_FUNCTIONS["yarn"](hf, "cpu")
    got, got_factor = rope.yarn_inv_freq(dim, spec["rope_theta"], spec, 4096)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got_factor == pytest.approx(factor, rel=1e-12)
    mine, mine_factor = ref.yarn(dim, spec, 4096)
    torch.testing.assert_close(mine.float(), want, rtol=1e-6, atol=0)
    assert mine_factor == pytest.approx(factor, rel=1e-12)
    cos, sin = rope.rope_angles(50, dim, spec["rope_theta"], scaling=spec,
                                max_positions=4096)
    ang = torch.outer(torch.arange(50, dtype=torch.float32), want)
    torch.testing.assert_close(cos, torch.cos(ang) * factor)
    torch.testing.assert_close(sin, torch.sin(ang) * factor)


def test_rope_tables_by_layer_type():
    pcfg = port_f32(tiny_config())
    tables = llama.rope_tables(pcfg, 16, "cpu")
    assert sorted(tables) == [0, 8]
    plain = rope.rope_angles(16, 32, 500000)
    torch.testing.assert_close(tables[8][0], plain[0])
    assert not torch.allclose(tables[0][0], plain[0])


# -- dropless routing -----------------------------------------------------------


def test_dropless_routing_matches_a_per_token_loop():
    cfg = moe.HybridMoEConfig(vocab_size=64, hidden=32, layers=1, heads=4,
                              kv_heads=2, ffn=16, experts=8,
                              experts_per_token=3, routing="dropless",
                              dtype=torch.float32, remat=False)
    g = torch.Generator().manual_seed(5)
    lp = {k: v[0] for k, v in moe.init_params(cfg, g, "cpu")["layers"].items()}
    y = torch.randn(2, 24, 32, generator=g)
    out, aux = moe._moe_ffn(cfg, lp, y)
    probs = torch.softmax(y @ lp["router"], -1).reshape(-1, 8)
    want = torch.zeros(48, 32)
    counts = torch.zeros(8)
    for t, row in enumerate(y.reshape(-1, 32)):
        top = sorted(range(8), key=lambda e: (-float(probs[t, e]), e))[:3]
        gates = probs[t, top] / probs[t, top].sum()
        for e, w in zip(top, gates):
            hid = torch.nn.functional.silu(row @ lp["w_gate"][e]) * (
                row @ lp["w_up"][e])
            want[t] += w * (hid @ lp["w_down"][e])
            counts[e] += 1
    torch.testing.assert_close(out.reshape(48, 32), want, rtol=1e-5,
                               atol=1e-6)
    frac = counts / 48
    assert float(aux) == pytest.approx(
        float(8 * (frac * probs.mean(0)).sum()), rel=1e-6)


def _tiny_ctx():
    from portbench.run import Context

    cfg = tiny_config()
    cell = {"config": "tiny", "chips": 1, "driver": "train_hybrid",
            "traffic": dict(batch=1, seq=32, optimizer="adamw8bit", lr=3e-4,
                            weight_decay=0.1, remat_policy="full",
                            xent_chunk=16, pool=2),
            "limits": {"median_grad_diff": 0.25}}
    return Context("tiny", SEED, 0.0, False, device="cpu", cell=cell,
                   config=cfg)


def test_route_witness_imposes_the_routes_it_is_given():
    """``calibrate_routes``: a side given its own recorded routes steps to
    the same gradients, given other experts to others; the witness reads
    every layer's share of differing routes and the three gradient gaps."""
    from portbench import calibrate_routes as cr

    ctx = _tiny_ctx()
    rec = cr.Routes()
    first, _ = cr.program_first(ctx, rec)
    assert sorted(rec.got) == list(range(4))
    same, _ = cr.program_first(ctx, cr.Routes(rec.got))
    assert all(torch.equal(first[k], same[k]) for k in first)
    other = {n: (r + 1) % 8 for n, r in rec.got.items()}
    moved, _ = cr.program_first(ctx, cr.Routes(other))
    diffs = cr.grad_diffs(moved, first, "cpu")
    assert diffs["layers.w_down"] > 0.1 and diffs["layers.router"] > 0.1

    got = cr.witness(ctx)
    assert set(got["median_grad_diff"]) == {
        "as_run", "reference_on_program_routes",
        "program_on_reference_routes"}
    for tokens, assignments in zip(*got["routes_differ"].values()):
        assert 0 <= assignments <= tokens <= 1
    assert len(got["routes_differ"]["tokens"]) == 4
    assert all(0 <= v < 1 for v in got["median_grad_diff"].values())


def test_grouped_mm_plain_matches_per_group_products():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(10, 6, generator=g), torch.randn(3, 6, 4, generator=g)
    ends = torch.tensor([4, 4, 10], dtype=torch.int32)   # group 1 empty
    got = grouped_gemm.grouped_mm(x, w, ends)
    want = torch.cat([x[:4] @ w[0], x[4:] @ w[2]])
    torch.testing.assert_close(got, want)


# -- refusals -------------------------------------------------------------------


def test_named_refusals():
    cfg = port_f32(tiny_config())
    coord = MeshCoord(plan_axes(2, expert=2), {"expert": 0})
    with pytest.raises(ValueError, match="dropless routing"):
        moe.Layout(cfg, coord)
    with pytest.raises(ValueError, match="sliding-window.*ring or Ulysses"):
        moe.Layout(cfg, attn_fn=lambda q, k, v: q)
    with pytest.raises(ValueError, match="sliding-window.*pipeline stage"):
        llama.Layout(cfg, pipeline_stage=True)
    dense = llama.HybridLlamaConfig(vocab_size=64, hidden=32, layers=2,
                                    heads=4, kv_heads=2, ffn=64, layer_types=(
                                        llama.SLIDING, llama.FULL),
                                    sliding_window=4)
    from tpu_network_operator_torch.models import generate

    with pytest.raises(ValueError, match="sliding-window.*serving"):
        generate.generate({"embed": torch.zeros(64, 32)},
                          torch.zeros(1, 4, dtype=torch.long), dense, 2)
    with pytest.raises(ValueError, match="layer_types"):
        llama.HybridLlamaConfig(layers=2, layer_types=(llama.FULL,))
    with pytest.raises(ValueError, match="sliding_window"):
        llama.HybridLlamaConfig(layers=1, layer_types=(llama.SLIDING,))
    with pytest.raises(ValueError, match="routing"):
        moe.HybridMoEConfig(routing="lossy")


def test_hybrid_config_round_trips_through_cfg_json():
    cfg = port_f32(tiny_config())
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    back = convert.cfg_from_json(convert.cfg_to_json(cfg))
    assert back == cfg and hash(back) == hash(cfg)


# -- the capacity path, unchanged ----------------------------------------------


# moe.MoEConfig.tiny()'s capacity routing (bf16) on init_params(seed 1234)
# and tokens of seed 7, read before dropless routing came
CAPACITY_LOSS = 6.04140043258667
CAPACITY_GRAD_NORMS = {
    "wq": 1.0855563879013062, "wk": 1.066672921180725,
    "wv": 1.6244574785232544, "wo": 1.5816932916641235,
    "router": 0.5032815933227539, "w_gate": 0.8897849917411804,
    "w_up": 0.8564523458480835, "w_down": 1.2317686080932617,
    "ln_attn": 0.2475907802581787, "ln_mlp": 0.17407016456127167}
CAPACITY_LOGITS = (382.78904247283936, 12648.101952552795)
CAPACITY_AUX = 1.8617143630981445


def test_capacity_path_outputs_unchanged():
    cfg = moe.MoEConfig.tiny()
    assert moe.routing(cfg) == "capacity"
    params = moe.init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    params = {k: ({n: t.requires_grad_() for n, t in v.items()}
                  if isinstance(v, dict) else v.requires_grad_())
              for k, v in params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(7))
    loss = moe.loss_fn(params, tokens, cfg)
    loss.backward()
    assert float(loss) == pytest.approx(CAPACITY_LOSS, rel=1e-6)
    for name, norm in CAPACITY_GRAD_NORMS.items():
        got = float(params["layers"][name].grad.float().norm())
        assert got == pytest.approx(norm, rel=1e-6), name
    with torch.no_grad():
        logits, aux = moe.forward(params, tokens[:, :-1], cfg)
    assert float(logits.double().sum()) == pytest.approx(
        CAPACITY_LOGITS[0], rel=1e-6)
    assert float(logits.double().abs().sum()) == pytest.approx(
        CAPACITY_LOGITS[1], rel=1e-6)
    assert float(aux) == pytest.approx(CAPACITY_AUX, rel=1e-6)
    assert math.isfinite(float(loss))


# -- the benchmark's readers of this cell ---------------------------------------


def _cell_trace():
    """One profiled step of a sliding and a full layer and a dropless MoE
    layer, as the card's profiler lists them (``test_portbench_spans``'s
    ``Trace``): flash kernels in ``attn.window`` / ``attn.full`` (the
    window's backward on the engine's thread, put down to its forward
    op), the permutes' gathers, a grouped GEMM and an elementwise kernel in
    ``moe.experts``."""
    from portbench.tests.test_portbench_spans import Trace, reading

    tr = Trace()
    tr.host("train.forward", 1, 0, 100)
    tr.host("attn.window", 1, 1, 10)
    tr.host("_FlashAttention", 1, 2, 9, seq=3)
    tr.kernel(1, 3, 100, 104, name="void flash_fwd_kernel<128, true>")
    tr.host("attn.full", 1, 11, 20)
    tr.kernel(1, 12, 104, 120, name="void flash_fwd_kernel<128, false>")
    tr.host("moe.permute", 1, 21, 30)
    tr.kernel(1, 22, 120, 123, name="vectorized_gather_kernel")
    tr.host("moe.experts", 1, 31, 40)
    tr.kernel(1, 32, 123, 133, name="cutlass::gemm::GemmUniversal")
    tr.kernel(1, 33, 133, 135, name="silu_kernel")
    tr.host("moe.unpermute", 1, 41, 50)
    tr.kernel(1, 42, 135, 137, name="vectorized_gather_kernel")
    tr.host("train.backward", 1, 100, 300)
    tr.host("autograd::engine::evaluate_function: _FlashAttentionBackward",
            2, 150, 200, seq=3, fwd_thread=1)
    tr.kernel(2, 151, 200, 208, name="void flash_bwd_dq_kernel<128, true>")
    return reading(tr.events)


def _cell_t(events):
    with open(CONFIG) as f:
        cfg = json.load(f)
    return {"kind": "train", "reading": events, "profiled_steps": 1,
            "config": cfg, "steps": 10, "window_s": 20.0,
            "device_kind": "NVIDIA H100 80GB HBM3",
            "traffic": {"batch": 1, "seq": 32768}}


def test_hybrid_readers_on_a_synthetic_trace():
    from portbench import common, costs, costs_hybrid, spans

    t = _cell_t(_cell_trace())

    def read(name):
        return common.load_module("metrics", name).read(t)

    assert read("attn_window_ms.train") == pytest.approx(0.012)
    assert read("attn_full_ms.train") == pytest.approx(0.016)
    assert read("moe_permute_ms.train") == pytest.approx(0.005)
    flops, nbytes = costs_hybrid.flash_window_cost(t["config"], 1, 32768)
    bound = costs.bound_s(flops, nbytes, t["device_kind"])
    assert read("flash_window_roofline.train") == pytest.approx(
        100 * bound / 12e-6)
    gemm = costs_hybrid.grouped_experts_flops(t["config"], 1, 32768)
    assert read("grouped_experts_roofline.train") == pytest.approx(
        100 * gemm / 989e12 / 10e-6)
    assert read("mfu_hybrid.train") == pytest.approx(
        100 * costs_hybrid.train_step_flops(t["config"], 1, 32768) * 10
        / 20.0 / 989e12)
    # the shared attribution keeps its own region names
    assert spans.of(t).spans.get("attn.window") is None
    assert "attn.window" not in spans.REGIONS


def test_hybrid_readers_find_nothing_on_a_program_without_the_spans():
    from portbench import common
    from portbench.tests.test_portbench_spans import Trace, reading

    tr = Trace()
    tr.host("train.forward", 1, 0, 100)
    tr.kernel(1, 3, 100, 104, name="void flash_fwd_kernel<128>")
    t = _cell_t(reading(tr.events))
    for name in ("attn_window_ms.train", "attn_full_ms.train",
                 "moe_permute_ms.train", "flash_window_roofline.train",
                 "grouped_experts_roofline.train"):
        reader = common.load_module("metrics", name)
        assert reader.read(t) is None and reader.read({}) is None, name


def test_expert_load_max_reads_the_counter():
    from torch.profiler import ProfilerActivity, profile

    from portbench import common
    from tpu_network_operator_torch import tracing

    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(16):
            tracing.count("moe.load_max", torch.tensor(8192))
    t = _cell_t(None)
    reader = common.load_module("metrics", "expert_load_max.train")
    # an even load puts 8 x 32768 / 64 = 4096 assignments on each expert
    assert reader.read(t) == pytest.approx(200.0)
    tracing.reset_counters()


def test_hybrid_step_flops():
    from portbench import costs, costs_hybrid

    with open(CONFIG) as f:
        cfg = json.load(f)
    assert costs_hybrid.train_step_flops(cfg, 1, 32768) / 1e12 == \
        pytest.approx(392.7, abs=0.05)
    band = costs_hybrid.band_pairs(32768, 1024)
    assert band / costs.causal_pairs(32768) == pytest.approx(0.0615,
                                                             abs=1e-4)
    assert costs_hybrid.band_pairs(100, 1024) == costs.causal_pairs(100)
