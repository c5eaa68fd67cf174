"""Device ms a step of the expert GEMMs: the batched products whose
operands are [E, B x C, h] and [E, h, f] (and back), forward, recomputed
and backward."""

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    cfg = t["config"]
    e, f = cfg["num_local_experts"], cfg["intermediate_size"]

    def group(shapes):
        dims = [s for s in shapes if s and len(s) == 3]
        if len(dims) >= 2 and all(s[0] == e for s in dims[:2]) \
                and any(f in s for s in dims[:2]):
            return "expert"
        return None

    ms = t["reading"].gemm_s(group).get("expert")
    return None if not ms else 1e3 * ms / t["profiled_steps"]
