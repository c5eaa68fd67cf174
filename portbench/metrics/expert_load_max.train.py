"""The busiest expert's load against an even one: the program's counter
``moe.load_max`` (the busiest expert's assignments in each layer's
forward, summed over the layers of the profiled steps) over k x tokens / E
x layers x steps.  100% is an even load."""

from portbench import spans

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "hybrid_moe":
        return None
    busiest = spans.counter("moe.load_max")
    if busiest is None:
        return None
    cfg, tr = t["config"], t["traffic"]
    even = (cfg["num_experts_per_tok"] * tr["batch"] * tr["seq"]
            / cfg["num_experts"])
    return 100.0 * busiest / (even * cfg["num_hidden_layers"]
                              * t["profiled_steps"])
