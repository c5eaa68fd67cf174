"""Median over the traced call's decode steps of the device-busy ms of one
``generate.decode_step`` span: the union of the device intervals of the
work it launched."""

from portbench import spans

LAYER = "decode loop (host, models/generate.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    return spans.median_or_none(
        spans.per_instance_ms(t, "generate.decode_step"))
