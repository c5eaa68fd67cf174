"""Share of the parameter values that kernel 8 stepped in the profiled
steps: the program's counter ``optim.adamw_fused_elems`` over the leaves'
values times the steps.  None where the cell's optimizer is not ``adamw``
or the program keeps no such counter."""

from portbench import spans

LAYER = "train step: optimizer (models/training.py AdamW, models/optim8bit.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["traffic"]["optimizer"] != "adamw":
        return None
    stepped = spans.counter("optim.adamw_fused_elems")
    if stepped is None:
        return None
    values = sum(numel for numel, _ in t["leaves"])
    return 100.0 * stepped / (values * t["profiled_steps"])
