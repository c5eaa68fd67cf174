"""Device ms a step of the work launched inside the program's
``train.optimizer`` span (the optimizer's ``apply``): what
``optimizer_ms.train`` reads from two host-timed calls, read from the
traced steps instead."""

from portbench import spans

LAYER = "train step: optimizer (models/training.py AdamW, models/optim8bit.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train":
        return None
    return spans.phase_ms(t, "train.optimizer")
