"""The hybrid MoE train step's model FLOPs over the window, as a share of
the card's bf16 peak (``costs_hybrid.train_step_flops``: the attention
projections, the top-k experts' products and the router, the vocabulary
projection, and attention over the pairs each layer sees: causal on full
layers, the window's band on sliding ones)."""

from portbench import costs, costs_hybrid

LAYER = "train step (models/training.py make_train_step)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "hybrid_moe" \
            or not t["steps"]:
        return None
    tr = t["traffic"]
    flops = costs_hybrid.train_step_flops(t["config"], tr["batch"], tr["seq"])
    return 100.0 * flops * t["steps"] / t["window_s"] / costs.peaks(
        t["device_kind"])[1]
