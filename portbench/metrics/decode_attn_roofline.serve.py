"""The bytes the decode-attention kernel must move over the traced call's
decode steps (every layer's K and V of the filled keys, q read and o
written once) at the card's memory bandwidth, as a share of the device
time of the kernel's launches, found by name."""

from portbench import costs

LAYER = "kernels (ops/csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"
KERNELS = ("decode_attn",)
ITEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def step_bytes(cfg, batch: int, keys: int) -> float:
    """One decode step over ``keys`` filled cache slots, every layer."""
    d, item = cfg["head_dim"], ITEM_BYTES[cfg["torch_dtype"]]
    kv = 2 * keys * cfg["num_key_value_heads"] * d
    qo = 2 * cfg["num_attention_heads"] * d
    return cfg["num_hidden_layers"] * batch * (kv + qo) * item


def read(t):
    if t.get("kind") != "decode":
        return None
    secs = t["reading"].kernel_s(*KERNELS)
    if secs <= 0:
        return None
    tr = t["traffic"]
    # the traced call makes 2 + trace_steps new tokens: its decode steps
    # write positions prompt .. prompt + trace_steps and attend one more
    nbytes = sum(step_bytes(t["config"], tr["batch"], tr["prompt"] + i + 1)
                 for i in range(tr["trace_steps"] + 1))
    return 100.0 * costs.bound_s(0.0, nbytes, t["device_kind"]) / secs
