"""The train step's model FLOPs over the window, as a share of the card's
bf16 peak (``costs.train_step_flops``: no recompute, no capacity padding,
no dispatch einsums)."""

from portbench import costs

LAYER = "train step (models/training.py make_train_step)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or not t["steps"]:
        return None
    tr = t["traffic"]
    flops = costs.train_step_flops(t["config"], tr["batch"], tr["seq"])
    return 100.0 * flops * t["steps"] / t["window_s"] / costs.peaks(
        t["device_kind"])[1]
