"""Multi-GPU layouts of the port: the job mesh over torch.distributed
ranks (one GPU per rank), the collectives of the sharded model, and
sequence parallelism (ring and Ulysses attention).

Counterpart of ``tpu_network_operator/parallel/``.  Expert parallelism
lives in the MoE model (``models/moe.py``); the pipeline schedules and
the collectives sweep are later slices (ROADMAP.md, queue 1 item 3).
"""

from .mesh import (  # noqa: F401
    AXES,
    Mesh,
    MeshCoord,
    MeshPlan,
    as_dtensor,
    dcn_collective,
    global_shape,
    host_device_mesh,
    init_process_group,
    make_mesh,
    mesh_from_bootstrap,
    placements,
    plan_axes,
    plan_block,
    plan_from_bootstrap,
    planned_axis_order,
    planned_ring_index,
    validate_axis_order,
)
