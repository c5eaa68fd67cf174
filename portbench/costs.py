"""The yardstick's arithmetic: the chip's published peaks, the model
FLOPs of a train step and of a ``generate`` call, and the operations and
bytes of the kernels whose roofline share is reported.

Bounds follow one rule: the least time is the larger of operations over
the peak rate and bytes over the memory bandwidth, each input read once,
each output written once, causal pairs only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# published dense peaks of one card: (HBM bytes/s, bf16 tensor FLOP/s),
# NVIDIA's data sheet, SXM part, at its 700 W limit.  A name is matched by
# the first key it holds, so "H100 PCIe" is tried before "H100".
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100": (3.35e12, 989e12),
}


def peaks(kind: str) -> Tuple[float, float]:
    for key, val in PEAKS.items():
        if key in kind:
            return val
    raise ValueError(f"no published peaks for {kind!r}")


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    bw, fl = peaks(kind)
    return max(flops / fl, nbytes / bw)


def _geometry(cfg: Dict):
    return (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"], cfg["vocab_size"])


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters of one layer that multiply each token: attention
    projections, the FFN a token passes through (top-k experts), the
    router."""
    h, f, _, hq, hkv, d, _ = _geometry(cfg)
    attn = h * (hq + 2 * hkv) * d + hq * d * h
    if cfg["family"] == "moe":
        k, e = cfg["num_experts_per_tok"], cfg["num_local_experts"]
        return attn + k * 3 * h * f + h * e
    return attn + 3 * h * f


def attn_pair_flops(cfg: Dict) -> int:
    """FLOPs of one (query, key) pair in one layer's forward: QK^T and PV
    over every query head."""
    _, _, _, hq, _, d, _ = _geometry(cfg)
    return 4 * hq * d


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x the matmul parameters a token
    meets (the vocabulary projection included, the embedding gather not)
    x tokens, plus causal attention forward and backward (3 x forward).
    No recompute, no capacity padding, no dispatch einsums."""
    h, _, n, _, _, _, v = _geometry(cfg)
    per_token = n * layer_matmul_params(cfg) + h * v
    attn = 3 * n * attn_pair_flops(cfg) * batch * causal_pairs(seq)
    return 6.0 * per_token * batch * seq + attn


def generate_flops(cfg: Dict, batch: int, prompt: int, new: int) -> float:
    """Model FLOPs of one ``generate`` call: the prompt's forward (logits
    needed at its last position only), then ``new - 1`` one-token steps,
    the step at position p attending p + 1 keys."""
    h, _, n, _, _, _, v = _geometry(cfg)
    body = n * layer_matmul_params(cfg)
    tokens = prompt + new - 1
    flops = 2.0 * body * batch * tokens + 2.0 * h * v * batch * new
    pairs = causal_pairs(prompt) + sum(prompt + t + 1 for t in range(new - 1))
    return flops + n * attn_pair_flops(cfg) * batch * pairs


def flash_train_cost(cfg: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the attention a train step needs: forward (QK^T,
    PV) and backward (S recomputed, dP, dV, dQ, dK: 2.5 x forward) over
    causal pairs; bytes: q, k, v, o and the row statistics written or read
    once forward, q, k, v, o, dO, the statistics read and dq, dk, dv
    written once backward, bf16 tensors and f32 statistics."""
    _, _, n, hq, hkv, d, _ = _geometry(cfg)
    fwd = attn_pair_flops(cfg) * batch * causal_pairs(seq)
    q = batch * seq * hq * d * 2
    kv = batch * seq * hkv * d * 2
    stats = batch * hq * seq * 4
    fwd_bytes = q + 2 * kv + q + stats
    bwd_bytes = (q + 2 * kv + 2 * q + 2 * stats) + (q + 2 * kv)
    return n * 3.5 * fwd, n * (fwd_bytes + bwd_bytes)


def adam8_bytes(leaves: Iterable[Tuple[int, int]], block: int = 256) -> float:
    """Bytes of one 8-bit AdamW update over leaves given as (values,
    parameter bytes a value): p read and written, g read, the int8 and
    float8 codes read and written, each block's two f32 scales read and
    written."""
    total = 0.0
    for numel, item in leaves:
        total += numel * (3 * item + 4) + (numel / block) * 16
    return total


def allreduce_busbw(calls: int, nbytes: int, ranks: int, seconds: float) -> float:
    """nccl-tests' bus bandwidth in GB/s: per-rank buffer bytes x
    2(n-1)/n a call, over the window."""
    return calls * nbytes * 2.0 * (ranks - 1) / ranks / seconds / 1e9

