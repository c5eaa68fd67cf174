"""The 8-bit AdamW update's bytes bound over every leaf of the cell
(``costs.adam8_bytes``) as a share of the device time of kernel 6 a step."""

from portbench import costs

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("adam8_fused_kernel",)


def read(t):
    if t.get("kind") != "train" or t["traffic"]["optimizer"] != "adamw8bit":
        return None
    secs = t["reading"].kernel_s(*KERNELS) / t["profiled_steps"]
    if secs <= 0:
        return None
    return 100.0 * costs.bound_s(0.0, costs.adam8_bytes(t["leaves"]),
                                 t["device_kind"]) / secs
