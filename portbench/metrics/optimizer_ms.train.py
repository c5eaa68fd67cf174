"""The optimizer's share of a train step: the median full step less the
median loss-and-backward call, each timed alone after the window (the
arithmetic of the port's ``measure.decompose``)."""

LAYER = "train step: optimizer (models/training.py AdamW, models/optim8bit.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    return 1e3 * (t["step_s"] - t["grad_s"])
