"""The port's collectives sweep and planned DCN all-reduce against the
reference's, in one process: the bus factors, the payload sizes
(``size_bytes``) of ``run_collective`` and ``time_dcn_all_reduce`` on the
reference's virtual 8-device CPU mesh, the result records, and the
refusals of ``workload collectives`` / ``workload exec-bench``.

The port's side runs in one spawned world-1 gloo process
(``run_ranks``).  There each axis of a plan of any size runs on that
world's one-rank group (``_OneRankAxes``), so ``run_collective`` and
``time_dcn_all_reduce`` size, cut and time the payload as at that axis
size; the collectives' outputs on several ranks are held to the
reference in ``test_torch_dist_collectives.py``.
"""

import contextlib
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks
from tpu_network_operator_torch.parallel import collectives as tcoll
from tpu_network_operator_torch.parallel.mesh import AXES

SIZES_MB = (0.25, 1.0, 3.0)
AXIS_SIZES = (1, 2, 4, 8)
# (dcn, ici) meshes of the planned all-reduce on the 8 virtual devices
DCN_ICI = ((1, 1), (2, 1), (1, 2), (2, 2), (2, 4), (4, 2))
DTYPES = ("bfloat16", "float32")
SIZE_OPS = ("all_reduce", "all_gather", "reduce_scatter")


def _jmesh(data, fsdp):
    import jax

    from tpu_network_operator.parallel import mesh as jmesh

    return jmesh.make_mesh(jmesh.plan_axes(data * fsdp, data=data, fsdp=fsdp),
                           devices=jax.devices()[:data * fsdp])


def _port_sizes(rank, world):
    """By dtype, size_bytes of the port's run_collective (each op of
    SIZE_OPS over ``fsdp`` of every AXIS_SIZES) and time_dcn_all_reduce
    (each DCN_ICI) at SIZES_MB, on this world-1 process's group."""
    import torch.distributed as dist

    from tpu_network_operator_torch.parallel import collectives as tc
    from tpu_network_operator_torch.parallel.mesh import MeshCoord, plan_axes

    class _OneRankAxes(MeshCoord):
        device = torch.device("cpu")

        def process_group(self, *axes):
            return dist.group.WORLD

    out = {}
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        runs, dcn = {}, {}
        for n in AXIS_SIZES:
            mesh = _OneRankAxes(plan_axes(n, fsdp=n), {})
            for op in SIZE_OPS:
                for size in SIZES_MB:
                    r = tc.run_collective(mesh, op, "fsdp", size, iters=1,
                                          dtype=dt)
                    assert r.seconds > 0
                    runs[(op, n, size)] = r.size_bytes
        for d, i in DCN_ICI:
            mesh = _OneRankAxes(plan_axes(d * i, data=d, fsdp=i), {})
            for size in SIZES_MB:
                r = tc.time_dcn_all_reduce(mesh, size, iters=1, dtype=dt)
                assert r.seconds > 0
                dcn[(d, i, size)] = r.size_bytes
        out[dtype] = runs, dcn
    return out


@pytest.fixture(scope="module")
def port_sizes():
    return run_ranks(1, _port_sizes)[0]


@pytest.mark.parametrize("op", [*tcoll.OPS, "dcn_all_reduce[ring]"])
def test_bus_factor_matches_reference(op):
    from tpu_network_operator.parallel import collectives as jcoll

    for n in range(1, 9):
        assert tcoll._bus_factor(op, n) == jcoll._bus_factor(op, n), n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", SIZE_OPS)
def test_run_collective_size_bytes_match_reference(port_sizes, op, dtype):
    import jax.numpy as jnp

    from tpu_network_operator.parallel import collectives as jcoll

    runs, _ = port_sizes[dtype]
    for n in AXIS_SIZES:
        mesh = _jmesh(1, n)
        for size in SIZES_MB:
            ref = jcoll.run_collective(mesh, op, "fsdp", size, iters=1,
                                       dtype=getattr(jnp, dtype))
            assert runs[(op, n, size)] == ref.size_bytes, (n, size)


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_dcn_all_reduce_size_bytes_match_reference(port_sizes, dtype):
    import jax.numpy as jnp

    from tpu_network_operator.parallel import collectives as jcoll

    _, dcn = port_sizes[dtype]
    for d, i in DCN_ICI:
        mesh = _jmesh(d, i)
        for size in SIZES_MB:
            ref = jcoll.time_dcn_all_reduce(mesh, size, iters=1,
                                            dtype=getattr(jnp, dtype))
            assert dcn[(d, i, size)] == ref.size_bytes, (d, i, size)
            # the reference's rounding: a multiple of n * ici * dcn * 4
            elems = ref.size_bytes // jnp.dtype(dtype).itemsize
            assert elems % (d * i * i * d * 4) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_collective_input_is_the_reference_array(dtype):
    """A rank's input is its block of the reference's
    ``arange(n_elems).astype(dtype)`` (the whole array for
    reduce_scatter)."""
    import jax.numpy as jnp

    from tpu_network_operator_torch.parallel.mesh import MeshCoord, plan_axes

    dt = getattr(torch, dtype)
    plan = plan_axes(4, data=2, fsdp=2)
    for op in tcoll.OPS:
        blocks = []
        for fsdp in range(2):
            mesh = MeshCoord(plan, {"data": 1, "fsdp": fsdp})
            mesh.device = torch.device("cpu")
            x, n_elems = tcoll.collective_input(mesh, op, "fsdp", 0.25, dt)
            blocks.append(x.float().numpy())
        whole = np.asarray(jnp.arange(n_elems, dtype=jnp.float32)
                           .astype(dtype).astype(jnp.float32))
        got = blocks[0] if op == "reduce_scatter" else np.concatenate(blocks)
        np.testing.assert_array_equal(got, whole)


def test_result_record_has_the_reference_keys():
    from tpu_network_operator.parallel import collectives as jcoll

    fields = dict(op="all_reduce", axis="fsdp", size_bytes=8, seconds=1.0,
                  algbw_gbps=2.0, busbw_gbps=3.0)
    assert tcoll.CollectiveResult(**fields).to_dict() == \
        jcoll.CollectiveResult(**fields).to_dict()
    assert tcoll.peak_busbw([tcoll.CollectiveResult(**fields)]) == 3.0
    assert tcoll.peak_busbw([]) == jcoll.peak_busbw([]) == 0.0


def test_unknown_collective_raises_the_reference_error():
    from tpu_network_operator.parallel import collectives as jcoll

    with pytest.raises(ValueError) as ref:
        jcoll._collective_fn("all_to_all", "fsdp", _jmesh(1, 2))
    with pytest.raises(ValueError) as port:
        tcoll._collective_fn("all_to_all", "fsdp", None)
    assert str(port.value) == str(ref.value) == "unknown collective 'all_to_all'"


def _cli(argv) -> dict:
    from tpu_network_operator_torch.workload import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def one_process(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)


def test_collectives_with_one_process_has_nothing_to_sweep(one_process):
    """One process and no group is a mesh of one rank on every axis: the
    default axis is the first of them, and the line is the reference's
    "nothing to sweep" line (``workload/collectives.py:20-22``)."""
    line = _cli(["collectives", "--device", "cpu"])
    assert line == {"metric": "collective busbw", "value": 0.0,
                    "unit": "GB/s", "axis": "data", "devices": 1}
    line = _cli(["collectives", "--device", "cpu", "--axis", "tensor"])
    assert line["axis"] == "tensor" and line["value"] == 0.0


def test_collectives_refuses_an_unknown_axis(one_process):
    from tpu_network_operator_torch.workload import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["collectives", "--device", "cpu", "--axis", "ici"])
    assert str(e.value) == (
        f"unknown mesh axis 'ici'; choose from {list(AXES)}")


def test_exec_bench_requires_a_bootstrap(one_process):
    from tpu_network_operator.workload.execbench import cmd_exec_bench
    from tpu_network_operator_torch.workload import cli

    with pytest.raises(SystemExit) as ref:
        cmd_exec_bench(SimpleNamespace(bootstrap=None))
    with pytest.raises(SystemExit) as port:
        cli.main(["exec-bench", "--device", "cpu"])
    assert str(port.value) == str(ref.value)
    assert "requires --bootstrap" in str(port.value)
