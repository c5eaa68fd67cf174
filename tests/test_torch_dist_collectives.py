"""The port's collectives on 4 gloo ranks against the reference's
``shard_map`` collectives on 4 virtual CPU devices, bit for bit.

One 4-rank world is spawned once and runs every case; the parent gathers
each case's per-rank outputs into the global array and holds it to the
reference's global output on the same input:

* each op of the sweep over ``fsdp`` 4, and over each axis of data 2 x
  fsdp 2 (``_collective_fn``: all_reduce and ppermute sharded over the
  axis, reduce_scatter from the whole array, all_gather to it);
* the planned DCN all-reduce (``make_dcn_all_reduce``), ring and
  hierarchical, at dcn 2 x ici 2 with ``data`` outermost and with
  ``fsdp`` outermost (the uniform plan's order, where a rank's block is
  its (data, fsdp) index, not its global rank);
* hierarchical at ici 1 runs as ring: one all-reduce, no reduce-scatter
  or all-gather (the ``torch.distributed`` calls counted);
* ``size_bytes`` of ``run_collective`` and ``time_dcn_all_reduce`` at
  these axis sizes, and ``workload collectives --device cpu`` on the
  ranks.

Inputs are integers small enough that every summation order gives the
same value in f32 and in bf16 (sums of 4 values under 64: at most 252,
exact in bf16's 8 bits), so the comparison is exact.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

WORLD = 4
N_ELEMS = 64
OPS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")
DTYPES = ("float32", "bfloat16")
# name -> (plan_axes keywords over 4 ranks, axis order or None)
MESHES = {
    "fsdp4": (dict(fsdp=4), None),
    "data2_fsdp2": (dict(data=2, fsdp=2), None),
    "fsdp2_data2": (dict(data=2, fsdp=2),
                    ("fsdp", "data", "pipe", "expert", "seq", "tensor")),
    "data4_fsdp1": (dict(data=4, fsdp=1), None),
}
OP_CASES = [(mesh, axis, op, dtype)
            for mesh, axes in (("fsdp4", ("fsdp",)),
                               ("data2_fsdp2", ("data", "fsdp")))
            for axis in axes for op in OPS for dtype in DTYPES]
DCN_CASES = [(mesh, strategy, dtype)
             for mesh in ("data2_fsdp2", "fsdp2_data2", "data4_fsdp1")
             for strategy in ("ring", "hierarchical") for dtype in DTYPES]
SIZE_MB = 0.25
# the reference's in / out specs of each op over its axis
SHARDED_IN = {"all_reduce": True, "all_gather": True,
              "reduce_scatter": False, "ppermute": True}
SHARDED_OUT = {"all_reduce": True, "all_gather": False,
               "reduce_scatter": True, "ppermute": True}


def _global_input(seed):
    return np.random.default_rng(seed).integers(
        0, 64, N_ELEMS).astype(np.float32)


def _plan(name, world=WORLD):
    from tpu_network_operator_torch.parallel import plan_axes

    axes, order = MESHES[name]
    return plan_axes(world, axis_order=order, **axes)


class _Counted:
    """The torch.distributed collectives wrapped to count their calls."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")

    def __init__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)

    @contextlib.contextmanager
    def __call__(self):
        import torch.distributed as dist

        saved = {n: getattr(dist, n) for n in self.NAMES}

        def wrap(name):
            def call(*a, **kw):
                self.counts[name] += 1
                return saved[name](*a, **kw)
            return call

        for n in self.NAMES:
            setattr(dist, n, wrap(n))
        try:
            yield self.counts
        finally:
            for n, f in saved.items():
                setattr(dist, n, f)


def _world_rank(rank, world):
    """Every case on this rank: its outputs (f32) and mesh coordinates;
    the dist call counts of the DCN all-reduce; the sizes; the CLI line."""
    from tpu_network_operator_torch.parallel import collectives as tc
    from tpu_network_operator_torch.parallel import make_mesh
    from tpu_network_operator_torch.workload import cli

    meshes = {name: make_mesh(_plan(name, world), "cpu") for name in MESHES}
    res = {"coord": {name: m.coord for name, m in meshes.items()},
           "ops": {}, "dcn": {}, "calls": {}}
    for i, (name, axis, op, dtype) in enumerate(OP_CASES):
        mesh = meshes[name]
        x = torch.from_numpy(_global_input(i)).to(getattr(torch, dtype))
        if SHARDED_IN[op]:
            x = x.chunk(mesh.size(axis))[mesh.coord[axis]].clone()
        out = tc._collective_fn(op, axis, mesh)(x)
        res["ops"][(name, axis, op, dtype)] = out.float().numpy()
    for i, (name, strategy, dtype) in enumerate(DCN_CASES):
        mesh = meshes[name]
        x = torch.from_numpy(_global_input(100 + i)).to(getattr(torch, dtype))
        x = x.chunk(mesh.size("data", "fsdp"))[mesh.index("data", "fsdp")]
        fn = tc.make_dcn_all_reduce(mesh, "data", "fsdp", strategy)
        counted = _Counted()
        with counted() as counts:
            out = fn(x.clone())
        res["dcn"][(name, strategy, dtype)] = out.float().numpy()
        res["calls"][(name, strategy, dtype)] = dict(counts)

    res["dcn_input"] = {
        name: tc.dcn_input(meshes[name], SIZE_MB)[0].float().numpy()
        for name in ("data2_fsdp2", "fsdp2_data2")}
    res["sizes"] = {
        op: tc.run_collective(meshes["fsdp4"], op, "fsdp", SIZE_MB, iters=1)
        .to_dict() for op in OPS}
    res["sizes"].update({
        strategy: tc.time_dcn_all_reduce(meshes["data2_fsdp2"], SIZE_MB,
                                         strategy=strategy, iters=1).to_dict()
        for strategy in ("ring", "hierarchical")})

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["collectives", "--device", "cpu", "--sizes-mb",
                         str(SIZE_MB), "--iters", "1"]) == 0
    res["cli"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return res


@pytest.fixture(scope="module")
def world4():
    return run_ranks(WORLD, _world_rank)


def _jax_mesh(name):
    import jax

    from tpu_network_operator.parallel import mesh as jmesh

    axes, order = MESHES[name]
    return jmesh.make_mesh(jmesh.plan_axes(WORLD, axis_order=order, **axes),
                           devices=jax.devices()[:WORLD])


def _assemble(world4, kind, key, name, axes):
    """The global array from every rank's output sharded over ``axes``
    (all of them, dcn outermost; ``()`` for a replicated output): each
    rank's block at its index along ``axes``, and ranks at the same index
    equal."""
    blocks = {}
    for r in world4:
        coord = r["coord"][name]
        idx = 0
        for a in axes:
            idx = idx * MESHES_SIZES[name][a] + coord[a]
        out = r[kind][key]
        if idx in blocks:
            np.testing.assert_array_equal(out, blocks[idx])
        blocks[idx] = out
    return np.concatenate([blocks[i] for i in sorted(blocks)])


MESHES_SIZES = {name: dict(zip(("data", "fsdp"),
                               (axes.get("data", 1), axes["fsdp"])))
                for name, (axes, _) in MESHES.items()}


@pytest.mark.parametrize("case", OP_CASES, ids="-".join)
def test_collective_matches_reference(world4, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_network_operator.parallel import collectives as jcoll

    name, axis, op, dtype = case
    i = OP_CASES.index(case)
    mesh = _jax_mesh(name)
    x = jnp.asarray(_global_input(i)).astype(dtype)
    x = jax.device_put(x, NamedSharding(
        mesh, P(axis) if SHARDED_IN[op] else P()))
    ref = np.asarray(jcoll._collective_fn(op, axis, mesh)(x)
                     .astype(jnp.float32))
    got = _assemble(world4, "ops", case, name,
                    (axis,) if SHARDED_OUT[op] else ())
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", DCN_CASES, ids="-".join)
def test_dcn_all_reduce_matches_reference(world4, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_network_operator.parallel import collectives as jcoll

    name, strategy, dtype = case
    i = DCN_CASES.index(case)
    mesh = _jax_mesh(name)
    x = jax.device_put(jnp.asarray(_global_input(100 + i)).astype(dtype),
                       NamedSharding(mesh, P(("data", "fsdp"))))
    ref = np.asarray(jcoll.make_dcn_all_reduce(
        mesh, "data", "fsdp", strategy)(x).astype(jnp.float32))
    got = _assemble(world4, "dcn", case, name, ("data", "fsdp"))
    np.testing.assert_array_equal(got, ref)
    # every element is the total over the 4 ranks' blocks
    np.testing.assert_array_equal(
        got, np.tile(_global_input(100 + i).reshape(4, -1).sum(0), 4))


@pytest.mark.parametrize("name", ["data2_fsdp2", "fsdp2_data2"])
def test_dcn_input_is_the_reference_block_of_each_rank(world4, name):
    """A rank's block of the timed all-reduce's input is the one the
    reference's ``P((data, fsdp))`` puts on the device at its (data,
    fsdp) coordinate, also where fsdp is outermost and the global rank
    order is not data-major."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _jax_mesh(name)
    n_elems = sum(r["dcn_input"][name].size for r in world4)
    x = jax.device_put(
        jnp.arange(n_elems, dtype=jnp.float32).astype(jnp.bfloat16),
        NamedSharding(mesh, P(("data", "fsdp"))))
    names = list(mesh.axis_names)
    blocks = {}
    for shard in x.addressable_shards:
        where = np.argwhere(mesh.devices == shard.device)[0]
        coord = (int(where[names.index("data")]),
                 int(where[names.index("fsdp")]))
        blocks[coord] = np.asarray(shard.data.astype(jnp.float32))
    for rank, r in enumerate(world4):
        coord = (r["coord"][name]["data"], r["coord"][name]["fsdp"])
        np.testing.assert_array_equal(r["dcn_input"][name], blocks[coord])
    if name == "fsdp2_data2":
        # rank 1 sits at data 1, fsdp 0: block 2 of 4, not block 1
        assert (world4[1]["coord"][name]["data"],
                world4[1]["coord"][name]["fsdp"]) == (1, 0)


@pytest.mark.parametrize("name", ["data2_fsdp2", "fsdp2_data2",
                                  "data4_fsdp1"])
def test_dcn_all_reduce_issues_the_planned_calls(world4, name):
    """ring: one all-reduce; hierarchical: reduce-scatter, all-reduce,
    all-gather -- except at ici 1 (fsdp 1), where it runs as ring and
    never issues a 1-way scatter/gather pair."""
    ring = {"all_reduce": 1, "reduce_scatter_tensor": 0,
            "all_gather_into_tensor": 0}
    hier = {"all_reduce": 1, "reduce_scatter_tensor": 1,
            "all_gather_into_tensor": 1}
    for r in world4:
        for dtype in DTYPES:
            assert r["calls"][(name, "ring", dtype)] == ring
            want = ring if name == "data4_fsdp1" else hier
            assert r["calls"][(name, "hierarchical", dtype)] == want


def test_size_bytes_match_reference(world4):
    import jax

    from tpu_network_operator.parallel import collectives as jcoll

    fsdp4, d2f2 = _jax_mesh("fsdp4"), _jax_mesh("data2_fsdp2")
    for r in world4:
        for op in OPS:
            got = r["sizes"][op]
            ref = jcoll.run_collective(fsdp4, op, "fsdp", SIZE_MB, iters=1)
            assert got["size_bytes"] == ref.size_bytes, op
            assert set(got) == set(ref.to_dict())
            assert got["seconds"] > 0 and got["busbw_gbps"] > 0
        for strategy in ("ring", "hierarchical"):
            got = r["sizes"][strategy]
            ref = jcoll.time_dcn_all_reduce(d2f2, SIZE_MB, strategy=strategy,
                                            iters=1)
            assert (got["op"], got["axis"], got["size_bytes"]) == (
                ref.op, ref.axis, ref.size_bytes)
    assert len(jax.devices()) >= WORLD


def test_workload_collectives_sweeps_the_largest_axis(world4):
    """``workload collectives --device cpu`` on 4 ranks: the default axis
    is fsdp (4), and the line carries the reference's keys
    (``workload/collectives.py:33-40``) with every op in ``results``."""
    for r in world4:
        line = r["cli"]
        assert set(line) == {"metric", "value", "unit", "axis", "axis_size",
                             "results"}
        assert (line["metric"], line["unit"], line["axis"],
                line["axis_size"]) == ("collective busbw", "GB/s", "fsdp", 4)
        assert [x["op"] for x in line["results"]] == list(OPS)
        assert all(x["seconds"] > 0 for x in line["results"])
        assert line["value"] == round(
            max(x["busbw_gbps"] for x in line["results"]), 2)
