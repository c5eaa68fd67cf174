"""The yardstick's arithmetic against sums written out by hand at a tiny
shape."""

from __future__ import annotations

import pytest

from portbench import costs

DENSE = dict(family="dense", hidden_size=8, intermediate_size=16,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, head_dim=4, vocab_size=10)
MOE = dict(DENSE, family="moe", num_local_experts=4, num_experts_per_tok=2)


def test_layer_params():
    attn = 8 * (2 + 2 * 1) * 4 + 2 * 4 * 8          # q, k, v, o
    assert costs.layer_matmul_params(DENSE) == attn + 3 * 8 * 16
    assert costs.layer_matmul_params(MOE) == attn + 2 * 3 * 8 * 16 + 8 * 4


def test_train_flops_by_hand():
    b, s = 3, 5
    per_token = 2 * costs.layer_matmul_params(DENSE) + 8 * 10
    pairs = 1 + 2 + 3 + 4 + 5
    attn = 3 * 2 * (4 * 2 * 4) * b * pairs
    assert costs.train_step_flops(DENSE, b, s) == 6 * per_token * b * s + attn


def test_generate_flops_by_hand():
    b, p, n = 2, 3, 4
    body = 2 * costs.layer_matmul_params(DENSE)
    # prompt positions 0..2, then steps at positions 3, 4, 5
    pairs = (1 + 2 + 3) + (4 + 5 + 6)
    want = (2 * body * b * (p + n - 1) + 2 * 8 * 10 * b * n
            + 2 * (4 * 2 * 4) * b * pairs)
    assert costs.generate_flops(DENSE, b, p, n) == want


def test_flash_cost_by_hand():
    b, s = 1, 4
    fwd = 4 * 2 * 4 * b * 10                         # 10 causal pairs
    flops, nbytes = costs.flash_train_cost(DENSE, b, s)
    assert flops == 2 * 3.5 * fwd
    q, kv, st = b * s * 2 * 4 * 2, b * s * 1 * 4 * 2, b * 2 * s * 4
    fwd_bytes = q + 2 * kv + q + st
    bwd_bytes = q + 2 * kv + 2 * q + 2 * st + q + 2 * kv
    assert nbytes == 2 * (fwd_bytes + bwd_bytes)


def test_adam8_bytes_and_busbw():
    # bf16: p r/w 4, g 2, m r/w 2, v r/w 2 = 10 a value; f32 14
    assert costs.adam8_bytes([(512, 2), (256, 4)]) == pytest.approx(
        512 * 10 + 2 * 16 + 256 * 16 + 16)
    assert costs.allreduce_busbw(10, 1_000_000_000, 4, 1.0) == 15.0


def test_bound_picks_the_larger():
    bw, fl = costs.peaks("NVIDIA H100 80GB HBM3")
    assert costs.bound_s(fl, 0.0, "NVIDIA H100 80GB HBM3") == 1.0
    assert costs.bound_s(0.0, 2 * bw, "NVIDIA H100 80GB HBM3") == 2.0
    with pytest.raises(ValueError):
        costs.peaks("cpu")
