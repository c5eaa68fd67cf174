"""Share of the traced generate call (prefill and ``trace_steps`` decode
steps at the cell's batch and cache length) in which no kernel or copy
runs on the device (the union of the profiler's device intervals)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    r = t["reading"]
    return 100.0 * (1.0 - r.busy_s / r.window_s)
