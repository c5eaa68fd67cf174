"""Device ms a step of the work launched inside the program's
``train.backward`` span (``models/training.py`` ``make_train_step``: the
gradient, with the remat recompute and the gradient reductions), on any
thread."""

from portbench import spans

LAYER = "train step (models/training.py make_train_step)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    return spans.phase_ms(t, "train.backward")
