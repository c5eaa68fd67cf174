"""The port's mesh planning and bootstrap reader against the reference's.

``plan_axes``, ``validate_axis_order``, the topology-plan helpers and
``mesh_from_bootstrap``'s plan give the reference's answers and errors on
the same inputs; the port's reader reads files the reference's agent
wrote, with and without a plan block, and refuses an unknown version; a
GPU host's processes map onto ranks, and a chip count that disagrees with
that world is refused; the job lock is the one the agent's drain waits
for; and a bootstrap file starts a gloo group and an all-ones mesh.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_network_operator.agent.tpu import bootstrap as jboot
from tpu_network_operator.agent.tpu.topology import TpuTopology
from tpu_network_operator.parallel import mesh as jmesh
from tpu_network_operator_torch import bootstrap as tboot
from tpu_network_operator_torch.parallel import mesh as tmesh

from test_torch_dist_attention import free_port, retry_on_taken_port

ROOT = Path(__file__).resolve().parents[1]

PLANS = [
    (8, {}),
    (8, dict(tensor=2, seq=2)),
    (8, dict(tensor=2, fsdp=2)),
    (16, dict(tensor=4, dcn_slices=2)),
    (8, dict(pipe=2, expert=2)),
    (8, dict(tensor=2, axis_order=("tensor", "seq", "expert", "pipe",
                                   "fsdp", "data"))),
    (4, dict(data=2, fsdp=2)),
]
BAD_PLANS = [
    (8, dict(tensor=3)),
    (8, dict(tensor=2, fsdp=3)),
    (12, dict(dcn_slices=5)),
    (8, dict(data=3, fsdp=None, tensor=1)),
    (8, dict(axis_order=("data", "fsdp"))),
    (8, dict(fsdp=2, data=2, dcn_slices=4)),
]


@pytest.mark.parametrize("n,kw", PLANS)
def test_plan_axes_matches_reference(n, kw):
    assert tmesh.plan_axes(n, **kw).axis_sizes == \
        jmesh.plan_axes(n, **kw).axis_sizes


@pytest.mark.parametrize("n,kw", BAD_PLANS)
def test_plan_axes_errors_match_reference(n, kw):
    with pytest.raises(ValueError) as ref:
        jmesh.plan_axes(n, **kw)
    with pytest.raises(ValueError) as port:
        tmesh.plan_axes(n, **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("order", [
    ("tensor", "seq", "expert", "pipe", "fsdp", "data"),
    ("data", "fsdp", "tensor"),
    ("data", "fsdp", "pipe", "expert", "seq", "tensor", "tensor"),
])
def test_validate_axis_order_matches_reference(order):
    try:
        want = jmesh.validate_axis_order(order)
    except ValueError as e:
        with pytest.raises(ValueError, match="not a permutation") as port:
            tmesh.validate_axis_order(order)
        assert str(port.value) == str(e)
    else:
        assert tmesh.validate_axis_order(order) == want


PLAN_BLOCKS = [
    None,
    {},
    {"meshAxisOrder": ["tensor", "seq", "expert", "pipe", "fsdp", "data"],
     "collective": "hierarchical", "ring": ["a", "b"], "ringIndex": 1},
    {"meshAxisOrder": ["data", "bogus"], "collective": "ring",
     "ringIndex": True},
    {"meshAxisOrder": "data", "collective": "other", "ringIndex": "2"},
]


def _write(tmp_path, plan, version=1, num_chips=8, num_slices=1,
           num_processes=2, process_id=1):
    topo = TpuTopology(accelerator_type="v5e-8", num_chips=num_chips,
                       chips_per_host=4, num_hosts=2, num_slices=num_slices)
    cfg = jboot.BootstrapConfig(
        coordinator_address="10.0.0.5:8476", num_processes=num_processes,
        process_id=process_id, topology=topo, plan=plan)
    path = tmp_path / "jax-coordinator.json"
    jboot.write_bootstrap(cfg, str(path))
    if version != 1:
        d = json.loads(path.read_text())
        d["version"] = version
        path.write_text(json.dumps(d))
    return str(path)


@pytest.mark.parametrize("plan", PLAN_BLOCKS,
                         ids=["none", "empty", "full", "mangled", "wrong"])
def test_reader_and_plan_helpers_match_reference(tmp_path, plan):
    path = _write(tmp_path, plan)
    ref, port = jboot.read_bootstrap(path), tboot.read_bootstrap(path)
    assert port.coordinator_address == ref.coordinator_address
    assert port.num_processes == ref.num_processes
    assert port.process_id == ref.process_id
    assert port.plan == ref.plan
    assert (port.topology.num_chips, port.topology.chips_per_host,
            port.topology.num_slices) == (ref.topology.num_chips,
                                          ref.topology.chips_per_host,
                                          ref.topology.num_slices)
    assert tmesh.plan_block(port) == jmesh.plan_block(ref)
    assert tmesh.planned_axis_order(port) == jmesh.planned_axis_order(ref)
    assert tmesh.dcn_collective(port) == jmesh.dcn_collective(ref)
    assert tmesh.planned_ring_index(port) == jmesh.planned_ring_index(ref)


@pytest.mark.parametrize("plan,chips,slices,kw", [
    (None, 8, 1, dict(tensor=2)),
    ({"meshAxisOrder": ["tensor", "seq", "expert", "pipe", "fsdp",
                        "data"]}, 4, 2, dict(seq=2)),
    (None, 2, 2, {}),
])
def test_mesh_from_bootstrap_plan_matches_reference(tmp_path, plan, chips,
                                                    slices, kw):
    import jax

    path = _write(tmp_path, plan, num_chips=chips, num_slices=slices)
    ref = jmesh.mesh_from_bootstrap(jboot.read_bootstrap(path),
                                    devices=jax.devices()[:chips * slices],
                                    **kw)
    port = tmesh.plan_from_bootstrap(tboot.read_bootstrap(path),
                                     world=chips * slices, **kw)
    assert port.names == tuple(ref.axis_names)
    assert port.shape == tuple(ref.devices.shape)


def test_unknown_version_is_a_hard_error(tmp_path):
    path = _write(tmp_path, None, version=2)
    with pytest.raises(jboot.BootstrapError, match="version 2"):
        jboot.read_bootstrap(path)
    with pytest.raises(tboot.BootstrapError,
                       match="unsupported bootstrap schema version 2"):
        tboot.read_bootstrap(path)


@pytest.mark.parametrize("process_id,local_rank,local_world,want", [
    (0, 0, 1, (0, 2)), (1, 0, 1, (1, 2)),
    (0, 3, 4, (3, 8)), (1, 2, 4, (6, 8)),
])
def test_gpu_rank_mapping(process_id, local_rank, local_world, want):
    cfg = tboot.BootstrapConfig(
        coordinator_address="h:1", num_processes=2, process_id=process_id,
        topology=tboot.Topology(num_chips=want[1]))
    assert tboot.gpu_rank(cfg, local_rank, local_world) == want


def test_gpu_rank_refuses_a_world_the_chips_disagree_with():
    cfg = tboot.BootstrapConfig(coordinator_address="h:1", num_processes=2,
                                topology=tboot.Topology(num_chips=8))
    with pytest.raises(tboot.BootstrapError, match="num_chips 8 x "
                                                   "num_slices 1 is not the "
                                                   "world of 2"):
        tboot.gpu_rank(cfg)
    with pytest.raises(tboot.BootstrapError, match="local rank 4"):
        tboot.gpu_rank(cfg, local_rank=4, local_world=4)
    with pytest.raises(tboot.BootstrapError, match="process_id 3"):
        tboot.gpu_rank(tboot.BootstrapConfig(num_processes=2, process_id=3))


def test_job_lock_is_what_the_agent_drain_waits_for(tmp_path):
    path = _write(tmp_path, None)
    lock = tboot.acquire_job_lock(path)
    try:
        assert jboot.job_active(path)
        assert json.loads(Path(jboot.lock_path(path)).read_text())[
            "token"] == lock.token
    finally:
        lock.release()
    assert not jboot.job_active(path)
    # another holder's lock is left alone
    other = tboot.acquire_job_lock(path)
    lock.release()
    assert jboot.job_active(path)
    other.release()
    assert not Path(jboot.lock_path(path)).exists()


def test_bootstrap_starts_a_gloo_group_and_an_all_ones_mesh(tmp_path):
    path = _write(tmp_path, None, num_chips=1, num_processes=1, process_id=0)
    d = json.loads(Path(path).read_text())

    def launch(_):
        d["coordinator_address"] = f"127.0.0.1:{free_port()}"
        Path(path).write_text(json.dumps(d))
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out

    code = (
        "import json, os, sys\n"
        "from argparse import Namespace\n"
        "import torch.distributed as dist\n"
        "from tpu_network_operator_torch.workload.common import (\n"
        "    build_mesh, init_distributed)\n"
        f"cfg, dev = init_distributed({path!r}, 'cpu')\n"
        "mesh = build_mesh(Namespace(tensor=1, seq=1, expert=1, pipe=1),\n"
        "                  cfg, dev)\n"
        f"held = os.path.exists({path!r} + '.lock')\n"
        "print(json.dumps([dist.get_backend(), dist.get_world_size(),\n"
        "                  mesh.shape, str(mesh.device), held]))\n"
        "dist.destroy_process_group()\n"
    )
    out = retry_on_taken_port(launch)
    backend, world, shape, device, held = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert (backend, world, device, held) == ("gloo", 1, "cpu", True)
    assert shape == dict.fromkeys(tmesh.AXES, 1)
    assert not Path(path + ".lock").exists()      # released at exit


def test_heads_that_do_not_divide_tensor_are_refused_where_the_reference_runs():
    """The divergence kept on purpose: ``LlamaConfig.tiny`` with 6 heads
    (head_dim 10, q width 60) over 4 tensor shards.  The reference's dense
    step runs on that mesh, because GSPMD reshards around the projections
    (15 q columns a shard, which cuts heads in two); the port's
    column-parallel projections need whole heads on each rank, so its
    ``Layout`` refuses the mesh with a named ValueError instead of
    resharding.  No preset meets the case at tensor 2, 4 or 8."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator_torch.models import llama as tllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), heads=6,
                               dtype=jnp.float32)
    mesh = jmesh.make_mesh(jmesh.plan_axes(4, tensor=4),
                           devices=jax.devices()[:4])
    step, init_all, _ = jllama.make_train_step(jcfg, mesh)
    params, opt_state = init_all(jax.random.key(0))
    tokens = jnp.zeros((4, 17), jnp.int32)
    _, _, loss = step(params, opt_state, tokens)
    assert np.isfinite(float(loss))

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), heads=6)
    coord = tmesh.MeshCoord(tmesh.plan_axes(4, tensor=4), {"tensor": 1})
    with pytest.raises(ValueError, match=r"tensor parallelism over 4 ranks "
                                         r"needs heads \(6\) and ffn \(128\) "
                                         "divisible by 4"):
        tllama.Layout(cfg, coord)


def test_training_over_pipe_is_refused_by_name():
    """The dense layout names no pipe axis, as the reference's specs name
    none: serving replicates over it (``test_torch_dist_generate.py``),
    and training over it runs through the pipeline's builders, whose
    stages hold a layout of their pipe coordinate.  The plain train
    step's layout refuses a pipe axis by name, naming the builder, rather
    than running replicas."""
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.models import moe as tmoe

    pipe = tmesh.MeshCoord(tmesh.plan_axes(2, pipe=2), {"pipe": 1})
    with pytest.raises(ValueError, match=r"training over a 'pipe' axis runs "
                                         r"through parallel\.pipeline\."
                                         r"make_pipeline_train_step"):
        tllama.Layout(tllama.LlamaConfig.tiny(), pipe)
    with pytest.raises(ValueError, match=r"parallel\.pipeline\."
                                         r"make_pipeline_train_step"):
        tmoe.Layout(tmoe.MoEConfig.tiny(), pipe)
    # a pipeline stage's layout, and serving's, take the axis
    for kw in (dict(pipeline_stage=True), dict(serving=True)):
        assert tllama.Layout(tllama.LlamaConfig.tiny(), pipe, **kw).heads == 4
