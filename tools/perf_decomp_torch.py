#!/usr/bin/env python3
"""Measured MFU decomposition of the port's train step at a bench rung's
geometry: the counterpart of ``tools/perf_decomp.py``.

Times each stage of the Llama train step on one CUDA device
(``tpu_network_operator_torch.measure.decompose``):

* ``fwd``  -- ``loss_fn`` under ``torch.no_grad`` (no graph, so no remat):
  the forward ceiling term;
* ``grad`` -- the loss and its backward: adds backward + remat recompute
  (under ``--remat-policy full`` the ideal is 4x fwd);
* ``step`` -- ``make_train_step``'s step: adds the AdamW update;
* ``matmul_probe`` -- 64 chained bf16 ``[b*s, hidden] @ [hidden, hidden]``
  products: what a plain ``torch.matmul`` reaches of the card's peak.

Prints one JSON line: seconds per stage, MFU at each stage, the
backward and optimizer multipliers, the probe, and the card's name and
power limit.  One device only: under a ``torch.distributed`` world above
1 (``WORLD_SIZE``), or with more than one visible CUDA device, the stages
would not describe the job's step, so it prints the reference's
``error`` line and exits 1.

Usage: python3 tools/perf_decomp_torch.py [--config llama3-1b]
    [--batch 4] [--seq 2048] [--iters 10] [--remat-policy full]
    [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_network_operator_torch.measure import decompose  # noqa: E402

CONFIGS = ("llama3-150m", "llama3-1b", "llama3-3b", "llama3-8b")


def refusal(device) -> str:
    """Why this process cannot decompose one device's step, or ''."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", 1))
    if dist.is_available() and dist.is_initialized():
        world = max(world, dist.get_world_size())
    if world > 1:
        return (f"perf_decomp assumes a single device (a torch.distributed "
                f"world of {world}): its stages are one process's unsharded "
                "step and would not describe the mesh's; run one process")
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    if n > 1:
        return (f"perf_decomp assumes a single device (found {n} CUDA "
                "devices): run with one visible, e.g. "
                "CUDA_VISIBLE_DEVICES=0")
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama3-1b", choices=CONFIGS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, a rehearsal at tiny sizes")
    args = ap.parse_args(argv)

    why = refusal(args.device)
    if why:
        print(json.dumps({"metric": "mfu decomposition", "value": 0.0,
                          "unit": "mfu", "vs_baseline": 0.0,
                          "error": why}))
        return 1
    from tpu_network_operator_torch.workload.common import llama_presets

    cfg = dataclasses.replace(llama_presets()[args.config](), xent_chunk=512,
                              remat_policy=args.remat_policy)
    print(json.dumps(decompose(cfg, args.batch, args.seq, args.iters,
                               args.device, name=args.config)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
