"""``workload exec-bench``: execute the operator's topology plan.

Counterpart of ``tpu_network_operator/workload/execbench.py``, the worker
half of ``tools/exec_bench_torch.py``: consume the agent-written
bootstrap (coordinator + plan block) as a production job would and time
the planned gradient all-reduce against the unplanned baseline on the
live process group, one process per device:

* **planned** mesh: :func:`mesh_from_bootstrap` (honours the plan's
  ``meshAxisOrder``), strategy from the plan's ``collective`` hint;
* **ring vs hierarchical**: both strategies on the planned mesh;
* **naive** mesh: the same topology facts with the axes in name order
  (the no-planner ordering), ring strategy.

Emits one JSON line with the per-size timings, the plan facts and the
sha256 of the bootstrap bytes read, which the launcher holds against
what the agent wrote.
"""

from __future__ import annotations

import hashlib

import torch.distributed as dist

from .common import emit, init_distributed, log, maybe_profile


def cmd_exec_bench(args) -> int:
    if not args.bootstrap:
        raise SystemExit("exec-bench requires --bootstrap (the plan "
                         "block rides the bootstrap file)")
    # the bytes as the agent left them, before anything else reads them
    with open(args.bootstrap, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    bootstrap, device = init_distributed(args.bootstrap, args.device)

    from ..parallel import (AXES, dcn_collective, make_mesh,
                            mesh_from_bootstrap, plan_axes, plan_block,
                            planned_axis_order)
    from ..parallel.collectives import time_dcn_all_reduce

    planned_mesh = mesh_from_bootstrap(bootstrap, device)
    topo = bootstrap.topology
    have_topo = topo is not None and topo.num_chips > 0
    world = dist.get_world_size()
    n = topo.num_chips * topo.num_slices if have_topo else world
    dcn = topo.num_slices if have_topo else 1
    naive_mesh = make_mesh(
        plan_axes(n, dcn_slices=dcn, axis_order=sorted(AXES)), device)
    strategy = dcn_collective(bootstrap)
    order = planned_axis_order(bootstrap)
    log(f"planned mesh {planned_mesh.shape} order {list(order)} "
        f"strategy {strategy}; naive mesh {naive_mesh.shape}")

    rows = []
    with maybe_profile(args.profile, "exec-bench", device):
        for size_mb in args.sizes_mb:
            # every rank runs the same collectives in the same order:
            # each call blocks until all ranks join it
            ring = time_dcn_all_reduce(
                planned_mesh, size_mb, strategy="ring", iters=args.iters)
            hier = time_dcn_all_reduce(
                planned_mesh, size_mb, strategy="hierarchical",
                iters=args.iters)
            naive = time_dcn_all_reduce(
                naive_mesh, size_mb, strategy="ring", iters=args.iters)
            planned = ring if strategy == "ring" else hier
            rows.append({
                "size_mb": size_mb,
                "size_bytes": planned.size_bytes,
                "planned_strategy": strategy,
                "planned_s": planned.seconds,
                "ring_s": ring.seconds,
                "hierarchical_s": hier.seconds,
                "naive_s": naive.seconds,
                "planned_algbw_gbps": round(planned.algbw_gbps, 3),
            })
            log(f"{size_mb:8.2f}MB planned[{strategy}] "
                f"{planned.seconds:.5f}s ring {ring.seconds:.5f}s "
                f"hier {hier.seconds:.5f}s naive {naive.seconds:.5f}s")

    emit({
        "metric": "executed planned DCN all-reduce",
        "value": round(max(r["planned_algbw_gbps"] for r in rows), 3),
        "unit": "GB/s",
        "process": bootstrap.process_id,
        "num_processes": bootstrap.num_processes,
        # one process per device
        "local_devices": 1,
        "global_devices": world,
        "mesh_planned": planned_mesh.shape,
        "mesh_naive": naive_mesh.shape,
        "mesh_axis_order": list(order),
        "collective_hint": strategy,
        "plan_version": plan_block(bootstrap).get("version", ""),
        "bootstrap_sha256": digest,
        "results": rows,
    })
    return 0
