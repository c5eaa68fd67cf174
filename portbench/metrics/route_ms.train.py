"""Device ms a step of the program's ``moe.route`` regions (the f32
router, its softmax, ``route``'s capacity routing and the aux loss),
forward, recomputed and backward."""

from portbench import spans

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    return spans.region_ms(t, "moe.route")
