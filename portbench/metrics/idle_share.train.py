"""Share of the traced train steps in which no kernel or copy runs on the
device (the union of the profiler's device intervals)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    r = t["reading"]
    return 100.0 * (1.0 - r.busy_s / r.window_s)
