"""Share of the top-k assignments that capacity routing drops: the
program's counter ``moe.assignments_dropped`` over the profiled steps'
forwards, of k x B x S x layers x steps."""

from portbench import spans

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    dropped = spans.counter("moe.assignments_dropped")
    if dropped is None:
        return None
    cfg, tr = t["config"], t["traffic"]
    total = (cfg["num_experts_per_tok"] * tr["batch"] * tr["seq"]
             * cfg["num_hidden_layers"] * t["profiled_steps"])
    return 100.0 * dropped / total
