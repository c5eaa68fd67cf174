"""Share of the experts' capacity slots that no token fills, the rows of
padding the expert GEMMs run: the program's counter ``moe.slots_empty``
over the profiled steps' forwards, of B x E x C x layers x steps."""

import math

from portbench import spans

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    empty = spans.counter("moe.slots_empty")
    if empty is None:
        return None
    cfg, tr = t["config"], t["traffic"]
    e = cfg["num_local_experts"]
    cap = max(math.ceil(cfg["num_experts_per_tok"] * tr["seq"] / e
                        * cfg["assumed"]["capacity_factor"]), 1)
    total = (tr["batch"] * e * cap * cfg["num_hidden_layers"]
             * t["profiled_steps"])
    return 100.0 * empty / total
