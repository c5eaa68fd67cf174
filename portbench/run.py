"""The port's benchmark: one cell, one run, one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``), its
traffic and the limits of its correctness check; ``BENCHMARK.json`` names
the metrics it reports.  With ``--trace 0`` those are its end-to-end
metrics; with ``--trace 1``, its per-layer metrics, each read by
``metrics/<metric>.py`` from the run's trace, counters and clocks.  The
last line of standard output is the result; the numbers compared for
``correct`` are the last lines of standard error.
"""

from __future__ import annotations

from portbench.common import Clock, pin_caches

CLOCK = Clock()
pin_caches()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import common  # noqa: E402


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    run's seed, window and trace switch, its device and set-up clock;
    ``fault`` and ``control`` are for the tests and the calibration of
    limits (``portbench/calibrate.py``), never set by a run."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", clock: Optional[Clock] = None,
                 cell: Optional[Dict] = None, config: Optional[Dict] = None,
                 fault: Optional[str] = None, control: bool = False):
        if cell is None or config is None:
            cell, config = common.workload(name)
        self.name = name
        self.cell, self.config = cell, config
        self.traffic = self.cell["traffic"]
        self.limits = self.cell.get("limits", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.clock = clock or Clock()
        self.fault, self.control = fault, control

    def memory_peak(self) -> int:
        if torch.device(self.device).type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated()

    def free_device(self) -> None:
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def device_kind(self) -> str:
        if torch.device(self.device).type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(0)


def measure(ctx: Context, bench: Dict) -> Dict:
    """Run the cell's driver; the result line and the numbers compared."""
    driver = importlib.import_module(f"portbench.drivers.{ctx.cell['driver']}")
    out = driver.run(ctx)
    checks = common.Checks()
    for name, value in out["compared"].items():
        if name in ctx.limits:
            checks.add(name, value, ctx.limits[name])
        else:
            # read and logged, not compared: no fault or control separates
            # it from sound runs (PERF.md)
            print(f"portbench: reading {name} = {value!r} (no limit)",
                  file=sys.stderr)
    e2e, per = common.cell_metrics(bench, ctx.name)
    metrics = {}
    if ctx.trace:
        for m in per:
            reader = common.load_module("metrics", m["name"])
            value = reader.read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": ctx.device_kind(),
              "count": out.get("device_count", ctx.cell["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": checks.ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        tr = out["trace"]
        reading = tr.get("reading")
        device["busy_s"] = reading.busy_s if reading else tr["busy_s"]
        device["window_s"] = (reading.window_s if reading
                              else tr["trace_window_s"])
        result["breakdown"] = (reading.breakdown() if reading
                               else tr["breakdown"])
    return {"result": result, "checks": checks, "out": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = common.benchmark()
    cell, _ = common.workload(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace),
                  clock=CLOCK)
    got = measure(ctx, bench)
    forbidden = sorted(set(common.forbidden_modules())
                       | set(got["out"].get("forbidden", ())))
    if forbidden:
        print(f"portbench: modules of the JAX side were loaded: {forbidden}",
              file=sys.stderr)
        return 3
    common.emit(got["result"], got["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
