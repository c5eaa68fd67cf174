"""The expert products of a dropless train step (three GEMMs over the
B x S x k routed rows, forward and backward, ``costs_hybrid``) at the
card's bf16 peak, as a share of the device time of the GEMM kernels (by
name) inside the program's ``moe.experts`` regions."""

from portbench import costs, costs_hybrid, spans_hybrid

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("gemm",)


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "hybrid_moe":
        return None
    secs = spans_hybrid.kernels_s(t, "moe.experts", KERNELS)
    if not secs:
        return None
    tr = t["traffic"]
    flops = costs_hybrid.grouped_experts_flops(t["config"], tr["batch"],
                                               tr["seq"])
    return 100.0 * costs.bound_s(flops, 0.0, t["device_kind"]) / secs
