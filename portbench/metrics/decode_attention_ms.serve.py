"""Device ms a decode step of the work launched inside the program's
``generate.attention`` spans within ``generate.decode_step`` spans (each
layer's cache write, the attended KV view and the attention over it),
over the traced call's decode steps."""

from portbench import spans

LAYER = "KV-cache attention (models/generate.py _block_with_cache)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    a = spans.of(t)
    if a is None or not a.has("generate.attention", "generate.decode_step"):
        return None
    ms = a.innermost_ms(("generate.attention",),
                        within="generate.decode_step")
    return ms / len(a.spans["generate.decode_step"]) if ms > 0 else None
