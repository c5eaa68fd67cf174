"""The attention a train step's shapes need (forward, dQ, dK/dV over
causal pairs, ``costs.flash_train_cost``) at the card's roofline, as a
share of the device time of the attention kernels named here."""

from portbench import costs

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(t):
    if t.get("kind") != "train":
        return None
    secs = t["reading"].kernel_s(*KERNELS) / t["profiled_steps"]
    if secs <= 0:
        return None
    tr = t["traffic"]
    flops, nbytes = costs.flash_train_cost(t["config"], tr["batch"], tr["seq"])
    return 100.0 * costs.bound_s(flops, nbytes, t["device_kind"]) / secs
