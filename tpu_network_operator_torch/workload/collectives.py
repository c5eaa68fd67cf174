"""``workload collectives``: the bandwidth sweep over one mesh axis."""

from __future__ import annotations

import torch.distributed as dist

from .common import (build_mesh, emit, init_distributed, log,
                     maybe_profile)


def cmd_collectives(args) -> int:
    from ..parallel.collectives import peak_busbw, sweep
    from ..parallel.mesh import AXES

    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
    # one process and no group: a mesh of one rank on every axis
    shape = mesh.shape if mesh is not None else dict.fromkeys(AXES, 1)
    axis = args.axis or max(shape, key=lambda a: shape[a])
    if axis not in shape:
        raise SystemExit(
            f"unknown mesh axis {axis!r}; choose from {list(shape)}"
        )
    if shape[axis] < 2:
        log(f"axis {axis!r} has size {shape[axis]}; nothing to sweep")
        emit({"metric": "collective busbw", "value": 0.0, "unit": "GB/s",
              "axis": axis,
              "devices": dist.get_world_size() if mesh is not None else 1})
        return 0
    with maybe_profile(args.profile, "collectives", device):
        results = sweep(
            mesh, axis=axis, sizes_mb=args.sizes_mb, iters=args.iters
        )
    for r in results:
        log(f"{r.op:15s} {r.size_bytes >> 20:5d}MB "
            f"alg {r.algbw_gbps:8.2f} GB/s bus {r.busbw_gbps:8.2f} GB/s")
    emit({
        "metric": "collective busbw",
        "value": round(peak_busbw(results), 2),
        "unit": "GB/s",
        "axis": axis,
        "axis_size": shape[axis],
        "results": [r.to_dict() for r in results],
    })
    return 0
