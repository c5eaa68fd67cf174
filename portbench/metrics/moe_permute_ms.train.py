"""Device ms a step of the program's ``moe.permute`` and ``moe.unpermute``
regions (dropless routing: the sort of the assignments by expert and the
gather of their rows, then the gates' weighted sum of each token's expert
outputs), forward, recomputed and backward."""

from portbench import spans_hybrid

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    return spans_hybrid.region_ms(t, "moe.permute", "moe.unpermute")
