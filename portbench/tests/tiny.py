"""Tiny copies of the benchmark's cells for the CPU tests: every width
cut so that a run takes seconds, the traffic's kinds and paths kept."""

from __future__ import annotations

import copy
from typing import Dict, Optional

from portbench import common

WIDTHS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              vocab_size=256)
TRAFFIC = {
    "train": dict(seq=64, xent_chunk=32),
    # one prompt batch: the sample checked is then the same however many
    # calls a short window holds
    "decode": dict(batch=4, prompt=16, new_tokens=8, decode_block=8,
                   check_rows=2, pool=1, check_calls=1),
    "allreduce": dict(calibrate_calls=5, warm_calls=1),
}
SEED = 2 ** 31 + 12345
# the bench entries the tiny runs report against
BENCH = {"end_to_end": [{"name": n, "unit": "u"} for n in (
    "train_tokens_per_s", "decode_tokens_per_s", "allreduce_busbw",
    "setup_s")], "per_layer": []}


# the all-reduce driver has no cell in BENCHMARK.json yet (PERF.md, Open
# questions): its tiny cell and configuration live here
ALLREDUCE = "nccl-fsdp4.allreduce-256m"
ALLREDUCE_CELL = {"config": "nccl-fsdp4", "chips": 4, "driver": "allreduce",
                  "traffic": {"calibrate_calls": 30, "warm_calls": 5,
                              "samples": 6}, "why": "", "limits": {}}
ALLREDUCE_CONFIG = {"name": "nccl-fsdp4", "family": "collective",
                    "ranks": 4, "axis": "fsdp", "op": "all_reduce",
                    "dtype": "bfloat16",
                    "buffer_bytes_per_rank": 268435456}


def cell(name: str, limits: Optional[Dict] = None):
    """(cell, config) of ``name`` at tiny widths, with ``limits`` in place
    of the cell's own (which are set for its full size)."""
    if name == ALLREDUCE:
        c, cfg = copy.deepcopy(ALLREDUCE_CELL), copy.deepcopy(ALLREDUCE_CONFIG)
    else:
        c, cfg = common.workload(name)
        c, cfg = copy.deepcopy(c), copy.deepcopy(cfg)
    if cfg["family"] == "collective":
        cfg.update(ranks=2, buffer_bytes_per_rank=1 << 14)
    else:
        cfg.update(WIDTHS)
        if cfg["family"] == "moe":
            cfg["num_local_experts"] = 4
    c["traffic"].update(TRAFFIC[c["driver"]])
    if limits is not None:
        c["limits"] = limits
    return c, cfg


def run(name: str, limits: Optional[Dict] = None, fault=None,
        control: bool = False, trace: bool = False, seed: int = SEED,
        seconds: float = 0.3):
    """One tiny run through the harness on the CPU (the look for a chip
    skipped): {"result", "checks", "out"}."""
    from portbench.run import Context, measure

    c, cfg = cell(name, limits)
    ctx = Context(name, seed, seconds, trace, device="cpu", cell=c,
                  config=cfg, fault=fault, control=control)
    return measure(ctx, BENCH)
