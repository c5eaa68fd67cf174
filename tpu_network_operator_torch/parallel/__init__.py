"""Multi-GPU layouts of the port: the job mesh over torch.distributed
ranks (one GPU per rank), the collectives of the sharded model, sequence
parallelism (ring and Ulysses attention), pipeline parallelism (the
GPipe, 1F1B and interleaved schedules, ``pipeline.py``), and the
collectives sweep with the planned DCN all-reduce (``collectives.py``)
that measure the network.

Counterpart of ``tpu_network_operator/parallel/``.  Expert parallelism
lives in the MoE model (``models/moe.py``).
"""

from .collectives import (  # noqa: F401
    CollectiveResult,
    dcn_all_reduce,
    make_dcn_all_reduce,
    peak_busbw,
    run_collective,
    sweep,
    time_dcn_all_reduce,
)

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

from .pipeline import make_pipeline_train_step  # noqa: F401
