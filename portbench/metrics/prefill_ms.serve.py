"""Device ms of the program's ``generate.prefill`` span in the traced
generate call: the prompt's pass over every layer and its first token."""

from portbench import spans

LAYER = "serving call (models/generate.py generate)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    return spans.inside_ms(t, "generate.prefill")
