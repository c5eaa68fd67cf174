"""Device ms a step of the GEMMs whose operand is the one-hot
[B, S, E, C] dispatch or combine tensor (an operand dim of E x C),
forward, recomputed and backward."""

import math

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    cfg, tr = t["config"], t["traffic"]
    e = cfg["num_local_experts"]
    slots = e * max(math.ceil(cfg["num_experts_per_tok"] * tr["seq"] / e
                              * cfg["assumed"]["capacity_factor"]), 1)

    def group(shapes):
        return "dispatch" if any(slots in s for s in shapes if s) else None

    ms = t["reading"].gemm_s(group).get("dispatch")
    return None if not ms else 1e3 * ms / t["profiled_steps"]
