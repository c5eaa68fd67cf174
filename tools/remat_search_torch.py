#!/usr/bin/env python3
"""Remat policy x optimizer x batch search of the port's Llama train step
at the bench geometry: the counterpart of ``tools/remat_search.py``.

Every combination of

* remat_policy: dots / ffn / ffn_offload (the saved FFN set in pinned
  host memory) / ffn_lite / full,
* optimizer (``--opts``): adam8 (adamw8bit, 8-bit moments) and adamw,
* batch (``--batches``),

at ``--seq`` with cross entropy in chunks of ``--xent-chunk``, through
``tpu_network_operator_torch.measure.measure`` (a first step, 2 warm
steps, 10 timed).  A combination whose residency estimate exceeds 0.95 of
the card's memory is skipped; a rung that runs out of device memory
(``torch.cuda.OutOfMemoryError``, and only that) is printed as ``fail``
and the sweep goes on.  Rows append to ``--out``; the best row prints
last as one JSON line.

Usage (one CUDA device): python3 tools/remat_search_torch.py
    [--config llama3-1b] [--batches 4,8] [--opts adam8,adamw]
    [--device cpu] (a CPU rehearsal: ``--config tiny``)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_network_operator_torch.measure import remat_search  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama3-1b")
    ap.add_argument("--batches", default="4,8")
    ap.add_argument("--opts", default="adam8,adamw",
                    help="comma list of optimizers to sweep: adam8 "
                         "(adamw8bit) and/or adamw (bf16 moments)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--xent-chunk", type=int, default=512)
    ap.add_argument("--out", default="remat_search.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_network_operator_torch.workload.common import (llama_presets,
                                                            pick_preset)

    base = pick_preset(llama_presets(), args.config, "llama")
    if args.config == "tiny":            # CI smoke only
        base = dataclasses.replace(base, remat=True)
    result = remat_search(
        base, args.config, [int(b) for b in args.batches.split(",")],
        args.opts.split(","), args.seq, args.xent_chunk, args.device,
        args.out, log=lambda msg: print(msg, flush=True))
    print(json.dumps(result["best"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
