"""Median host ms of one ``generate.decode_step`` span in the traced call
(under the profiler): the time the host takes to issue a decode step."""

from portbench import spans

LAYER = "decode loop (host, models/generate.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    a = spans.of(t)
    if a is None:
        return None
    return spans.median_or_none(
        [(s.end - s.start) / 1e3
         for s in a.spans.get("generate.decode_step", ())])
