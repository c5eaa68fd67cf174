"""CUDA kernels a decode step launches: the profiler's count over a call
of 2 + n new tokens less that over a call of 2, over the n steps between
(the calls' cache length is the cell's)."""

LAYER = "decode loop (host, models/generate.py)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    return t["step_launches"]
