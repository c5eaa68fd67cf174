"""The sliding layers' attention at the card's roofline (forward, dQ and
dK/dV over the band's pairs, ``costs_hybrid.flash_window_cost``), as a
share of the device time of the flash kernels inside the program's
``attn.window`` regions."""

from portbench import costs, costs_hybrid, spans_hybrid

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "hybrid_moe":
        return None
    secs = spans_hybrid.kernels_s(t, "attn.window", KERNELS)
    if not secs:
        return None
    tr = t["traffic"]
    flops, nbytes = costs_hybrid.flash_window_cost(t["config"], tr["batch"],
                                                   tr["seq"])
    return 100.0 * costs.bound_s(flops, nbytes, t["device_kind"]) / secs
