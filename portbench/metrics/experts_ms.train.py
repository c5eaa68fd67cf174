"""Device ms a step of the program's ``moe.experts`` regions (the three
expert einsums and the SwiGLU), forward, recomputed and backward, all
kernels: what ``expert_gemm_ms.train`` reads of the GEMMs alone."""

from portbench import spans

LAYER = "MoE routing and experts (models/moe.py route, _moe_ffn)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(t):
    if t.get("kind") != "train" or t["config"]["family"] != "moe":
        return None
    return spans.region_ms(t, "moe.experts")
