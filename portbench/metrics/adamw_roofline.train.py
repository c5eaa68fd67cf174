"""The AdamW update's bytes bound over every leaf of the cell, p read and
written, g read, m and v each read and written (7 values of the leaf's
dtype), at the card's bandwidth, as a share of the device time a step of
the kernels named ``adamw_fused`` (kernel 8).  None where the cell's
optimizer is not ``adamw`` or no such kernel ran."""

from portbench import costs

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("adamw_fused",)


def update_bytes(leaves) -> float:
    """Bytes of one update over leaves given as (values, bytes a value)."""
    return float(sum(numel * 7 * item for numel, item in leaves))


def read(t):
    if t.get("kind") != "train" or t["traffic"]["optimizer"] != "adamw":
        return None
    secs = t["reading"].kernel_s(*KERNELS) / t["profiled_steps"]
    if secs <= 0:
        return None
    return 100.0 * costs.bound_s(0.0, update_bytes(t["leaves"]),
                                 t["device_kind"]) / secs
