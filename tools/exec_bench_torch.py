#!/usr/bin/env python3
"""Plan-execution benchmark of the PyTorch port: prints ONE JSON line
(BENCH-style), the counterpart of ``tools/exec_bench.py``.

The same pipeline end to end, with the port's workers:

1. a FakeFabric fleet (one node per ``--procs-list`` entry's process) is
   probed with real Prober/Responder rounds and the measured RTT matrix
   feeds ``planner.compute_plan`` exactly as the reconciler would
   (``tools/exec_bench.py``'s ``compute_scenario_plan``);
2. each node's bootstrap is written by the agent path --
   ``build_bootstrap`` -> ``write_bootstrap`` -> ``apply_plan``
   (``write_rank_bootstraps``);
3. each node starts ``--devices-per-proc`` rank processes of ``python -m
   tpu_network_operator_torch.workload exec-bench --device cpu`` on its
   bootstrap file (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, one process per
   device, gloo), which read the file verbatim (sha256 held against what
   the agent wrote), form the world of procs x devices-per-proc ranks and
   time the DCN gradient all-reduce: planned mesh ring vs hierarchical,
   and planned axis order vs name order.

Scenarios, gates (exit 1 on failure), the watchdog and the scenario retry
are the reference launcher's: ``uniform`` (fewer than 4 nodes: one flat
group, the plan hints ``ring`` and puts fsdp outermost) and ``skewed`` (4+
nodes: two racks interleaved with the naming order, the plan hints
``hierarchical``); the hint must match the scenario, the planned order
must not lose to name order beyond ``--order-noise-tol``, and every rank
must have read the bytes the agent wrote.  All ranks share one host, so
the timings are same-host gloo, not a fabric's.

This launcher imports the operator's probe, planner and agent modules
(through ``tools/exec_bench.py``), none of the JAX workload.

Usage: python tools/exec_bench_torch.py [--procs-list 2,4]
           [--devices-per-proc 2] [--sizes-mb 0.25,1,4] [--iters 3]
           [--out FILE]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def _reference_launcher():
    """``tools/exec_bench.py`` as a module: its probe -> plan -> agent
    bootstrap pipeline, constants and gates' numbers (it imports only the
    standard library at the top, the operator's modules in its
    functions)."""
    spec = importlib.util.spec_from_file_location(
        "_exec_bench_reference", os.path.join(HERE, "exec_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_launcher()
log = ref.log
compute_scenario_plan = ref.compute_scenario_plan
write_rank_bootstraps = ref.write_rank_bootstraps


def spawn_workers(bootstraps, devices_per_proc, sizes_mb, iters):
    """``devices_per_proc`` ``workload exec-bench`` rank processes per
    node's bootstrap; returns each rank's parsed last JSON line, in rank
    order (node-major).  A poll loop watches all ranks at once: a rank
    dying early fails the run with its stderr tail, and no rank's stderr
    growing for ``STALL_TIMEOUT_S`` means the rendezvous wedged.  Every
    child is killed on any failure."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    cmd_tail = ["--sizes-mb", *[str(s) for s in sizes_mb],
                "--iters", str(iters)]
    procs = []
    logs = []
    try:
        for path, _ in bootstraps:
            for local in range(devices_per_proc):
                # stderr to a sidecar file: a PIPE would block a chatty
                # child once it fills
                err_f = open(f"{path}.{local}.stderr", "w+")
                logs.append(err_f)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "tpu_network_operator_torch.workload", "exec-bench",
                     "--device", "cpu", "--bootstrap", path, *cmd_tail],
                    cwd=ROOT,
                    env={**env, "LOCAL_RANK": str(local),
                         "LOCAL_WORLD_SIZE": str(devices_per_proc)},
                    stdout=subprocess.PIPE, stderr=err_f, text=True,
                ))
        deadline = time.monotonic() + ref.WORKER_TIMEOUT_S
        progress = sum(os.fstat(f.fileno()).st_size for f in logs)
        last_progress = time.monotonic()
        while any(p.poll() is None for p in procs):
            for rank, proc in enumerate(procs):
                rc = proc.poll()
                if rc is not None and rc != 0:
                    raise RuntimeError(
                        f"rank {rank} exited {rc}:\n"
                        f"stderr: {ref._tail(logs[rank])}"
                    )
            now = time.monotonic()
            grown = sum(os.fstat(f.fileno()).st_size for f in logs)
            if grown != progress:
                progress, last_progress = grown, now
            stalled = now - last_progress > ref.STALL_TIMEOUT_S
            if now > deadline or stalled:
                stuck = [
                    i for i, p in enumerate(procs) if p.poll() is None
                ]
                why = (
                    f"no rank made progress for {ref.STALL_TIMEOUT_S}s"
                    if stalled else
                    f"ranks still running after {ref.WORKER_TIMEOUT_S}s"
                )
                raise RuntimeError(
                    f"{why} (stuck: {stuck}); rank {stuck[0]} stderr: "
                    f"{ref._tail(logs[stuck[0]])}"
                )
            time.sleep(0.2)
        results = []
        for rank, proc in enumerate(procs):
            out = proc.stdout.read()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"rank {rank} exited {proc.returncode}:\n"
                    f"stderr: {ref._tail(logs[rank])}"
                )
            results.append(json.loads(out.strip().splitlines()[-1]))
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()
        for f in logs:
            f.close()


def run_scenario(tmpdir, n, devices_per_proc, scenario, seed,
                 sizes_mb, iters):
    log(f"== scenario {scenario}: {n} nodes x {devices_per_proc} rank "
        "processes")
    t0 = time.perf_counter()
    plan, modeled_planned_ms, modeled_naive_ms = compute_scenario_plan(
        n, scenario, seed
    )
    modeled_improvement = 100.0 * (
        1.0 - modeled_planned_ms / max(modeled_naive_ms, 1e-9)
    )
    for attempt in range(ref.SCENARIO_ATTEMPTS):
        bootstraps = write_rank_bootstraps(
            tmpdir, f"{scenario}{n}-a{attempt}", n, devices_per_proc, plan
        )
        try:
            ranks = spawn_workers(
                bootstraps, devices_per_proc, sizes_mb, iters
            )
            break
        except RuntimeError as e:
            if attempt + 1 >= ref.SCENARIO_ATTEMPTS:
                raise
            log(f"   attempt {attempt + 1} failed ({e}); retrying the "
                "scenario with a fresh coordinator")

    # rank r ran on node r // devices_per_proc's file
    bytes_verified = all(
        r["bootstrap_sha256"] == bootstraps[i // devices_per_proc][1]
        for i, r in enumerate(ranks)
    )
    r0 = ranks[0]
    ring_total = sum(row["ring_s"] for row in r0["results"])
    hier_total = sum(row["hierarchical_s"] for row in r0["results"])
    planned_total = sum(row["planned_s"] for row in r0["results"])
    naive_total = sum(row["naive_s"] for row in r0["results"])
    row = {
        "scenario": scenario,
        "procs": n,
        "devices_per_proc": devices_per_proc,
        "global_devices": r0["global_devices"],
        "mesh_planned": r0["mesh_planned"],
        "mesh_naive": r0["mesh_naive"],
        "mesh_axis_order": r0["mesh_axis_order"],
        "collective_hint": r0["collective_hint"],
        "expected_hint": (
            "hierarchical" if scenario == "skewed" else "ring"
        ),
        "plan_version": plan.version,
        "ring": plan.ring,
        "sizes_mb": [r["size_mb"] for r in r0["results"]],
        "results": r0["results"],
        "bootstrap_bytes_verified": bytes_verified,
        # measured deltas (positive = the planned side is faster)
        "measured_order_improvement_pct": round(
            100.0 * (1.0 - planned_total / max(naive_total, 1e-12)), 1
        ),
        "measured_hier_vs_ring_pct": round(
            100.0 * (1.0 - hier_total / max(ring_total, 1e-12)), 1
        ),
        # the planner's modeled objective over the SAME measured RTTs
        "modeled_planned_allreduce_ms": round(modeled_planned_ms, 3),
        "modeled_naive_allreduce_ms": round(modeled_naive_ms, 3),
        "modeled_improvement_pct": round(modeled_improvement, 1),
        "planned_total_s": round(planned_total, 5),
        "ring_total_s": round(ring_total, 5),
        "hierarchical_total_s": round(hier_total, 5),
        "naive_total_s": round(naive_total, 5),
        "scenario_seconds": round(time.perf_counter() - t0, 1),
    }
    row["measured_vs_modeled_gap_pp"] = round(
        row["modeled_improvement_pct"]
        - row["measured_order_improvement_pct"], 1
    )
    log(f"   -> hint {row['collective_hint']} "
        f"(want {row['expected_hint']}); planned {planned_total:.4f}s "
        f"naive {naive_total:.4f}s "
        f"({row['measured_order_improvement_pct']}% measured vs "
        f"{row['modeled_improvement_pct']}% modeled); "
        f"hier-vs-ring {row['measured_hier_vs_ring_pct']}%")
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--procs-list", default="2,4",
                    help="node counts; <4 runs the uniform scenario, "
                         ">=4 the skewed one (2 racks need 2 nodes each "
                         "for an intra-group RTT sample)")
    ap.add_argument("--devices-per-proc", type=int, default=2,
                    help="rank processes (one device each) per node, "
                         "sharing the node's bootstrap file")
    ap.add_argument("--sizes-mb", default="0.25,1,4",
                    help="payload sweep of the timed all-reduce")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed iterations per point (best-of)")
    ap.add_argument("--order-noise-tol", type=float,
                    default=ref.ORDER_NOISE_TOL,
                    help="same-host noise tolerance for the ordering "
                         "gate; the default suits the full sweep -- "
                         "single-size debug runs carry too few points "
                         "for it and should pass a looser value")
    ap.add_argument("--out", default="",
                    help="also write the JSON artifact to this path")
    args = ap.parse_args()
    procs = [int(s) for s in args.procs_list.split(",") if s.strip()]
    sizes_mb = [float(s) for s in args.sizes_mb.split(",") if s.strip()]

    rows = []
    with tempfile.TemporaryDirectory(prefix="exec-bench-torch-") as tmpdir:
        for n in procs:
            scenario = "skewed" if n >= 4 else "uniform"
            rows.append(run_scenario(
                tmpdir, n, args.devices_per_proc, scenario, args.seed,
                sizes_mb, args.iters,
            ))

    failures = []
    for row in rows:
        tag = f"{row['scenario']}@{row['procs']}p"
        if row["collective_hint"] != row["expected_hint"]:
            failures.append(
                f"{tag}: plan hinted {row['collective_hint']}, scenario "
                f"expects {row['expected_hint']}"
            )
        if row["planned_total_s"] > row["naive_total_s"] * (
            1.0 + args.order_noise_tol
        ):
            failures.append(
                f"{tag}: planned ordering lost to name-order beyond the "
                f"{args.order_noise_tol:.0%} noise tolerance "
                f"({row['planned_total_s']}s vs {row['naive_total_s']}s)"
            )
        if not row["bootstrap_bytes_verified"]:
            failures.append(
                f"{tag}: a worker consumed bootstrap bytes differing "
                "from what the agent wrote"
            )

    skewed = [r for r in rows if r["scenario"] == "skewed"]
    head = skewed[-1] if skewed else rows[-1]
    notes = [
        "measured-vs-modeled gap: the planner models "
        f"{head['modeled_improvement_pct']}% all-reduce improvement from "
        f"ring ordering on the {head['scenario']} fabric, while the "
        f"executed ordering delta on this rig is "
        f"{head['measured_order_improvement_pct']}% "
        f"(gap {head['measured_vs_modeled_gap_pp']} points): all "
        "processes share one host, so the modeled RTT structure does "
        "not exist on the wire -- the modeled number only transfers to "
        "fabrics whose topology the collectives actually traverse",
        "CPU-backend noise floor: same-host gloo timings jitter at "
        "small payloads; the ordering gate carries a "
        f"{args.order_noise_tol:.0%} tolerance",
    ]
    result = {
        "metric": "executed planned vs name-order DCN all-reduce",
        "value": head["measured_order_improvement_pct"],
        "unit": "percent",
        # planned/naive measured time ratio on the headline scenario
        "vs_baseline": round(
            head["planned_total_s"] / max(head["naive_total_s"], 1e-12), 3
        ),
        "modeled_improvement_pct": head["modeled_improvement_pct"],
        "measured_vs_modeled_gap_pp": head["measured_vs_modeled_gap_pp"],
        "measured_hier_vs_ring_pct": head["measured_hier_vs_ring_pct"],
        "order_noise_tol": args.order_noise_tol,
        "seed": args.seed,
        "procs_list": procs,
        "sizes_mb": sizes_mb,
        "devices_per_proc": args.devices_per_proc,
        "scenarios": rows,
        "notes": notes,
        "ok": not failures,
        "failures": failures,
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if failures:
        log("FAILED: " + "; ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
