"""The model FLOPs of the window's generate calls (prefill and decode,
``costs.generate_flops``) as a share of the card's bf16 peak."""

from portbench import costs

LAYER = "serving call (models/generate.py generate)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode" or not t["calls"]:
        return None
    tr = t["traffic"]
    flops = costs.generate_flops(t["config"], tr["batch"], tr["prompt"],
                                 tr["new_tokens"])
    return 100.0 * flops * t["calls"] / t["window_s"] / costs.peaks(
        t["device_kind"])[1]
