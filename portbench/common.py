"""What every driver shares: where the benchmark's files are, the build
caches, the isolation check, the clock of a run's set-up, the device's
description and the one JSON line a run prints."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
# whole top-level module names no run may hold: the JAX package and what
# it runs on (compared whole: the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_network_operator", "bench",
             "__graft_entry__")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """The set-up clock: process start to the first timed operation, less
    the seconds the correctness check spends reading the program's state
    during set-up (that is the check's time, not set-up)."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()
        self.check_s = 0.0

    def setup_s(self, window_start: float) -> float:
        return window_start - self.t0 - self.check_s


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # the 7B model's eager AdamW fits beside its state only without the
    # caching allocator's fixed segments
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def read_json(*parts: str) -> Dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name: str) -> Tuple[Dict, Dict]:
    """(the cell's file, its configuration's file)."""
    cell = read_json("workloads", f"{name}.json")
    return cell, read_json("configs", f"{cell['config']}.json")


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Checks:
    """The numbers compared for ``correct``, each with its limit."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def ok(self) -> bool:
        return bool(self.items) and all(v <= lim for _, v, lim in self.items)

    def record(self) -> Dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}


def emit(result: Dict, checks: Checks) -> None:
    """The numbers compared, as the last lines of standard error, then the
    result as the last line of standard output (``limits`` last)."""
    for n, v, lim in checks.items:
        print(f"check {n} = {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["limits"] = checks.record()
    print(json.dumps(line), flush=True)
