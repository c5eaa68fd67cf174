"""Device ms a step of the program's ``attn.full`` regions: the
attention of the full layers (``models/llama.py`` ``_attn_half``),
forward, recomputed and backward."""

from portbench import spans_hybrid

LAYER = "attention (models/llama.py _attn_half, ops/flash_attention.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    return spans_hybrid.region_ms(t, "attn.full")
