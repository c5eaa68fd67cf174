"""The readings that limits are set from, outside any benchmark run.

    python3 -m portbench.calibrate --workload <cell> --seed <n> \
        --seconds <s> [--control] [--fault <name>]

Runs the cell as a run does, at its own size, and prints one JSON line of
the numbers it compares: the program's (``compared``), with ``--control``
the float8 control's as well, and with ``--fault`` the program's with
that fault planted (train: ``unchanged``, ``half_batch``; decode:
``token``; all-reduce: ``no_exchange``, ``answer``).  The benchmark's own
runs never do any of this.
"""

from __future__ import annotations

from portbench.common import Clock, pin_caches

CLOCK = Clock()
pin_caches()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import common  # noqa: E402
from portbench.run import Context, measure  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.workload, args.seed, args.seconds, False,
                  device=args.device, clock=CLOCK, fault=args.fault,
                  control=args.control)
    got = measure(ctx, common.benchmark())
    out = got["out"]
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "fault": args.fault, "compared": out["compared"],
                      "control": out.get("control"),
                      "metrics": got["result"]["metrics"],
                      "attempted": out["attempted"],
                      "memory_peak_bytes": out["memory_peak_bytes"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
