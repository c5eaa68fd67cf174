"""The work of a ``hybrid_moe`` train step (configs with ``layer_types``,
``moe_intermediate_size`` and ``num_experts``): its model FLOPs, and the
operations and bytes of the sliding-window flash kernels and of the
grouped expert GEMMs, for the readers of ``mellum2-l16.train-32k``.

The rules are ``costs.py``'s: 6 x the matmul parameters a token meets x
tokens plus 3 x attention forward, no recompute; a kernel's bound is the
larger of its operations at the bf16 peak and its bytes at the memory
bandwidth.  Attention counts the pairs each layer sees: causal on
"full_attention" layers, the band of the last ``sliding_window`` keys on
"sliding_attention" ones.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import costs

SLIDING = "sliding_attention"


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters of one layer that multiply each token: the attention
    projections, the top-k experts' three products, the router."""
    h, d = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    k, e = cfg["num_experts_per_tok"], cfg["num_experts"]
    f = cfg["moe_intermediate_size"]
    return h * (hq + 2 * hkv) * d + hq * d * h + k * 3 * h * f + h * e


def pair_flops(cfg: Dict) -> int:
    """FLOPs of one (query, key) pair in one layer's forward: QK^T and PV
    over every query head."""
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"]


def band_pairs(seq: int, window: int) -> int:
    """(query, key) pairs with q - window < k <= q over [0, seq)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def layer_pairs(cfg: Dict, seq: int):
    """Each layer's pairs: causal, or its window's band."""
    return [band_pairs(seq, cfg["sliding_window"]) if t == SLIDING
            else costs.causal_pairs(seq) for t in cfg["layer_types"]]


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (no recompute, no routing overhead)."""
    per_token = (cfg["num_hidden_layers"] * layer_matmul_params(cfg)
                 + cfg["hidden_size"] * cfg["vocab_size"])
    attn = 3 * pair_flops(cfg) * batch * sum(layer_pairs(cfg, seq))
    return 6.0 * per_token * batch * seq + attn


def flash_window_cost(cfg: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the sliding layers' attention in a train step:
    forward and backward (3.5 x forward) over their band's pairs; bytes
    per layer as ``costs.flash_train_cost`` counts them."""
    n = sum(t == SLIDING for t in cfg["layer_types"])
    fwd = pair_flops(cfg) * batch * band_pairs(seq, cfg["sliding_window"])
    one = dict(cfg, num_hidden_layers=1, intermediate_size=0,
               family="dense")
    _, nbytes = costs.flash_train_cost(one, batch, seq)
    return n * 3.5 * fwd, n * nbytes


def grouped_experts_flops(cfg: Dict, batch: int, seq: int) -> float:
    """FLOPs of the expert products in a train step: the three products
    over every routed row (B x S x k), forward and backward (3 x)."""
    rows = batch * seq * cfg["num_experts_per_tok"]
    per_row = 3 * 2 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return 3.0 * cfg["num_hidden_layers"] * rows * per_row
